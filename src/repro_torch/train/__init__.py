"""Training substrate of the port (counterpart of ``repro.train``): the
fault-tolerant loop. ``repro``'s explicit-DP compressed step comes in a
later slice."""

from repro_torch.train.loop import TrainLoopConfig, train_loop

__all__ = ["TrainLoopConfig", "train_loop"]

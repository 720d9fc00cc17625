"""Launch layer of the port (counterpart of ``repro.launch``): the serve and
train entry points, device meshes over ``torch.distributed`` (``mesh``)
and the rank-process launcher (``ranks``)."""

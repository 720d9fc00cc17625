"""Launch layer of the port (counterpart of ``repro.launch``): the serve and
train entry points, device meshes over ``torch.distributed`` and the
production ``MeshShape``s (``mesh``), the rank-process launcher
(``ranks``), the (arch x shape) cells (``steps``) and their dry-run on the
meta device (``dryrun``)."""

"""Launch layer of the port (counterpart of ``repro.launch``): the serve
entry point."""

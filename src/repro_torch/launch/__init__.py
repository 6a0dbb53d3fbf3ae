"""Launch layer of the port: the serving CLI (``python -m
repro_torch.launch.serve``) and the HLO cost analysis (``launch.hlo``)."""

"""Launch layer of the port: the serving and training CLIs (``python -m
repro_torch.launch.serve``, ``launch.train``), the HLO cost analysis
(``launch.hlo``) and the meshes of ranks (``launch.mesh``)."""

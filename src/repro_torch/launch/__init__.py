"""Step builders (``launch.steps``) and meshes (``launch.mesh``)."""

"""Step builders (``launch.steps``)."""

"""Training: the loop (``train.loop``) and Algorithm 2 as a remat
policy (``train.remat``)."""

"""Multi-device encoding: the band-sharded fixed-CU P stage on a mesh of
devices in one process (sharded.py) and the round-robin frame-span pipeline
across processes over torch.distributed (multihost.py)."""

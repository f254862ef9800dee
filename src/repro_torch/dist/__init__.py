"""Sharded execution — twin of `repro.dist`: halo plans and the flat halo
exchange over `torch.distributed` (`halo`), and the sharding policy the
model reads (`policy`)."""

"""Data and sample parallelism over torch.distributed ranks (PyTorch port of
localrf_tpu/parallel/): `sharding.py` splits the ray batch over a "data"
mesh axis, `sp.py` splits an eval march over a "sample" axis."""

"""Work across several GPUs (or several streams of one): `sharding`."""

"""The slab-sharded solve: ``sharding.py`` (the sharded field, the halo
exchange and the sharded wrappers) and ``poisson.py`` (the models)."""

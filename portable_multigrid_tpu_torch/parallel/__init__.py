"""The sharded solves: ``sharding.py`` (the sharded field, the halo
exchange and the sharded wrappers), ``poisson.py`` (the slab-sharded
Poisson models), ``mesh2d.py`` (the 2D-pencil Poisson solve) and
``elasticity.py`` (the slab-sharded elasticity solve)."""

from fedrann_jax.parallel.mesh import make_mesh, shard_rows  # noqa: F401

from fedrann_jax.knn.topk import knn_exact, normalize_rows  # noqa: F401

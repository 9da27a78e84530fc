from fedrann_jax.project.srp import build_precompute, icf_weights_device  # noqa: F401
from fedrann_jax.project.embed import embed_hits  # noqa: F401

from fedrann_jax.kmers.codec import (  # noqa: F401
    canonical_window_codes,
    splitmix64,
    u64_to_words,
    window_codes,
    words_to_u64,
)
from fedrann_jax.kmers.membership import (  # noqa: F401
    library_device_words,
    mirror_hits,
    read_hits,
)

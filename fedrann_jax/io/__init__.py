from fedrann_jax.io.fastx import (  # noqa: F401
    FastxRecord,
    open_maybe_gzipped,
    read_fastx,
    reverse_complement,
    sniff_format,
)
from fedrann_jax.io.packing import PackedReads, pack_reads  # noqa: F401
from fedrann_jax.io.tsv import (  # noqa: F401
    write_overlaps_path,
    write_overlaps_tsv,
)

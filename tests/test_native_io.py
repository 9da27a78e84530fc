"""Native C++ FASTX parser vs the pure-Python reader (the oracle)."""

import gzip
import subprocess

import numpy as np
import pytest

from fedrann_jax.io import native
from fedrann_jax.io.fastx import read_fastx
from fedrann_jax.io.packing import encode_bases, pack_reads
from fedrann_jax.sim import simulate_reads, write_fasta



@pytest.fixture(autouse=True)
def native_lib():
    """The native library is built from source at first use; these tests
    need it, so a failed build fails them."""
    assert native.native_available(), "native/fastxpack.cpp did not build"


def _check_file(path):
    py = list(read_fastx(path))
    names, codes, offsets = native.parse_fastx_native(path)
    assert names == [r.name for r in py]
    assert len(offsets) == len(py) + 1
    for i, rec in enumerate(py):
        got = codes[offsets[i] : offsets[i + 1]]
        assert np.array_equal(got, encode_bases(rec.sequence)), rec.name


def test_native_fasta_plain(tmp_path):
    p = tmp_path / "x.fasta"
    p.write_text(">r1 desc\nACGT\nacgtN\n>r2\nTTTTX\n>empty\n>r3\nGG\n")
    _check_file(str(p))


def test_native_fastq_gz(tmp_path):
    p = tmp_path / "x.fastq.gz"
    with gzip.open(p, "wt") as f:
        for i in range(50):
            f.write(f"@read{i} extra stuff\nACGTACGTN\n+\nIIIIIIIII\n")
    _check_file(str(p))


def test_native_large_roundtrip(tmp_path):
    sim = simulate_reads(genome_length=30000, coverage=5,
                         mean_read_length=2000, error_rate=0.03, seed=44)
    path = str(tmp_path / "reads.fasta.gz")
    write_fasta(path, sim.names, sim.sequences)
    _check_file(path)


def test_native_pack_matches_python(tmp_path):
    sim = simulate_reads(genome_length=20000, coverage=4,
                         mean_read_length=1500, seed=45)
    path = str(tmp_path / "reads.fasta")
    write_fasta(path, sim.names, sim.sequences)
    pk_native = native.pack_reads_native(path, (1024, 4096))
    pk_py = pack_reads(read_fastx(path), (1024, 4096))
    assert pk_native.names == pk_py.names
    assert pk_native.n_truncated == pk_py.n_truncated
    assert len(pk_native.buckets) == len(pk_py.buckets)
    for bn, bp in zip(pk_native.buckets, pk_py.buckets):
        assert np.array_equal(bn.bases, bp.bases)
        assert np.array_equal(bn.lengths, bp.lengths)
        assert np.array_equal(bn.read_index, bp.read_index)


def test_native_bad_file(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("not a fastx\n")
    with pytest.raises(ValueError):
        native.parse_fastx_native(str(p))


def test_native_overlaps_writer_matches_python(tmp_path):
    import io as _io

    from fedrann_jax.io.tsv import write_overlaps_path, write_overlaps_tsv

    rng = np.random.default_rng(70)
    names = [f"read_{i}" for i in range(20)]
    idx = rng.integers(-1, 40, size=(40, 5)).astype(np.int32)
    dist = rng.random((40, 5)).astype(np.float32)

    buf = _io.StringIO()
    n_py = write_overlaps_tsv(buf, names, idx, dist)
    p = tmp_path / "o.tsv"
    n_c = write_overlaps_path(str(p), names, idx, dist)
    assert n_c == n_py
    assert p.read_text() == buf.getvalue()


def test_bit_packed_pack_and_unpack_matches():
    """bit_packed parse + device unpack must reproduce the byte matrix."""
    import jax.numpy as jnp

    from fedrann_jax.kmers.codec import unpack_bases

    sim = simulate_reads(genome_length=15000, coverage=4,
                         mean_read_length=1200, seed=46)
    import tempfile, os
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "r.fasta")
    write_fasta(path, sim.names, sim.sequences)
    plain = native.pack_reads_native(path, (2048,))
    packed = native.pack_reads_native(path, (2048,), bit_packed=True)
    for bp, bb in zip(packed.buckets, plain.buckets):
        assert bp.bases is None and bp.packed_bases is not None
        got = np.asarray(unpack_bases(
            jnp.asarray(bp.packed_bases), jnp.asarray(bp.valid_bits),
            bp.length,
        ))
        assert np.array_equal(got, bb.bases)


def test_matrix_writer_matches_python(tmp_path):
    import io as _io

    from fedrann_jax.io.tsv import write_overlaps_path, write_overlaps_tsv

    rng = np.random.default_rng(71)
    names = [f"rd{i}" for i in range(30)]
    idx = rng.integers(-1, 60, size=(60, 4)).astype(np.int32)
    dist = rng.random((60, 4)).astype(np.float32)
    buf = _io.StringIO()
    n_py = write_overlaps_tsv(buf, names, idx, dist)
    p = tmp_path / "m.tsv"
    n_c = write_overlaps_path(str(p), names, idx, dist)
    assert n_c == n_py
    assert p.read_text() == buf.getvalue()


def test_matrix_writer_row_offset_chunks_concatenate(tmp_path):
    """Per-rank local-row writes (row_offset = global row of the chunk's
    first query) concatenated in rank order must reproduce the full-matrix
    write exactly — the multi-host output contract. Both the C and python
    writers honor row_offset."""
    import io as _io

    from fedrann_jax.io.tsv import HEADER, write_overlaps_path, write_overlaps_tsv

    rng = np.random.default_rng(72)
    names = [f"rd{i}" for i in range(30)]
    idx = rng.integers(-1, 60, size=(60, 4)).astype(np.int32)
    # plant self rows at their GLOBAL positions to exercise the filter
    idx[np.arange(0, 60, 7), 0] = np.arange(0, 60, 7)
    dist = rng.random((60, 4)).astype(np.float32)

    full = tmp_path / "full.tsv"
    write_overlaps_path(str(full), names, idx, dist)

    parts = []
    total = 0
    for lo, hi in ((0, 22), (22, 40), (40, 60)):
        p = tmp_path / f"part{lo}.tsv"
        total += write_overlaps_path(str(p), names, idx[lo:hi], dist[lo:hi],
                                     row_offset=lo)
        parts.append(p.read_text()[len(HEADER):])
        # python writer agrees chunk-for-chunk
        buf = _io.StringIO()
        write_overlaps_tsv(buf, names, idx[lo:hi], dist[lo:hi], row_offset=lo)
        assert buf.getvalue() == p.read_text()
    assert HEADER + "".join(parts) == full.read_text()
    assert total == len(full.read_text().splitlines()) - 1


def test_threaded_parse_matches_single(tmp_path):
    sim = simulate_reads(genome_length=40000, coverage=6,
                         mean_read_length=1500, seed=47)
    path = str(tmp_path / "r.fasta")
    write_fasta(path, sim.names, sim.sequences)
    n1, c1, o1 = native.parse_fastx_native(path, threads=1)
    n4, c4, o4 = native.parse_fastx_native(path, threads=4)
    assert n1 == n4
    assert np.array_equal(o1, o4)
    assert np.array_equal(c1, c4)
    # gz input silently falls back to streaming
    gz = str(tmp_path / "r.fasta.gz")
    write_fasta(gz, sim.names, sim.sequences)
    ng, cg, og = native.parse_fastx_native(gz, threads=4)
    assert ng == n1 and np.array_equal(cg, c1)


def test_packed_cache_roundtrip(tmp_path):
    """Cache save/load must reproduce the PackedReads exactly and reject a
    changed input identity."""
    from fedrann_jax.io.cache import (
        cache_meta, load_packed_cache, save_packed_cache,
    )

    sim = simulate_reads(genome_length=30000, coverage=5,
                         mean_read_length=1200, seed=53)
    path = str(tmp_path / "r.fasta")
    write_fasta(path, sim.names, sim.sequences)
    for bit_packed in (True, False):
        packed = native.pack_reads_native(path, (2048, 4096),
                                          bit_packed=bit_packed)
        meta = cache_meta(path, (2048, 4096))
        cpath = str(tmp_path / f"c{bit_packed}.npz")
        save_packed_cache(cpath, packed, meta)
        got = load_packed_cache(cpath, meta)
        assert got is not None
        assert got.names == packed.names
        assert got.n_truncated == packed.n_truncated
        assert len(got.buckets) == len(packed.buckets)
        for a, b in zip(got.buckets, packed.buckets):
            assert a.length == b.length
            assert np.array_equal(a.lengths, b.lengths)
            assert np.array_equal(a.read_index, b.read_index)
            if b.bases is not None:
                assert np.array_equal(a.bases, b.bases)
            else:
                assert np.array_equal(a.packed_bases, b.packed_bases)
                assert np.array_equal(a.valid_bits, b.valid_bits)
        # different buckets -> miss
        assert load_packed_cache(cpath, cache_meta(path, (8192,))) is None
    # touched input -> miss
    import os, time
    os.utime(path, (time.time() + 10, time.time() + 10))
    assert load_packed_cache(cpath, cache_meta(path, (2048, 4096))) is None


def test_pipeline_uses_pack_cache(tmp_path):
    """Second pipeline run must produce identical results from the cache."""
    import os
    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline

    sim = simulate_reads(genome_length=15000, coverage=6,
                         mean_read_length=1200, seed=54)
    path = str(tmp_path / "r.fasta")
    write_fasta(path, sim.names, sim.sequences)
    out = str(tmp_path / "o")
    args = ["-i", path, "-o", out, "-k", "13", "--kmer-sample-fraction",
            "0.3", "-n", "64", "--nndescent-n-neighbors", "8",
            "--length-buckets", "4096", "--seed", "3"]
    r1 = run_pipeline(config_from_args(args))
    assert os.path.exists(os.path.join(out, "fxcache.npz"))
    r2 = run_pipeline(config_from_args(args))
    assert r1.names == r2.names
    assert np.array_equal(r1.neighbor_indices, r2.neighbor_indices)
    # --no-pack-cache still works and matches
    r3 = run_pipeline(config_from_args(args + ["--no-pack-cache"]))
    assert np.array_equal(r1.neighbor_indices, r3.neighbor_indices)


def test_lengths_unpack_matches_validbits_unpack(tmp_path):
    """unpack_bases_len (prefix-validity fast path) == unpack_bases for
    N-free reads; reads WITH mid-read Ns are detected and routed to the
    valid-bits path by the pipeline (popcount != length)."""
    import numpy as np
    import jax.numpy as jnp

    from fedrann_jax.io.fastx import FastxRecord
    from fedrann_jax.io.native import pack_reads_native
    from fedrann_jax.kmers.codec import unpack_bases, unpack_bases_len
    from fedrann_jax.sim import simulate_reads

    sim = simulate_reads(genome_length=8000, coverage=4,
                         mean_read_length=900, seed=3)
    fasta = str(tmp_path / "r.fasta")
    with open(fasta, "w") as f:
        for n, s in zip(sim.names, sim.sequences):
            f.write(f">{n}\n{s}\n")
    packed = pack_reads_native(fasta, (1024,), bit_packed=True)
    b = packed.buckets[0]
    a = unpack_bases(jnp.asarray(b.packed_bases), jnp.asarray(b.valid_bits),
                     b.length)
    c = unpack_bases_len(jnp.asarray(b.packed_bases),
                         jnp.asarray(b.lengths.astype(np.int32)), b.length)
    assert np.array_equal(np.asarray(a), np.asarray(c))
    # an N read breaks prefix validity: popcount < length
    with open(fasta, "a") as f:
        f.write(">with_n\nACGTNNACGTACGT\n")
    packed2 = pack_reads_native(fasta, (1024,), bit_packed=True)
    b2 = packed2.buckets[0]
    pop = np.unpackbits(b2.valid_bits, axis=1).sum(axis=1)
    assert (pop[: len(b2.lengths)] == b2.lengths).sum() == len(b2.lengths) - 1


def test_truncated_gzip_rejected(tmp_path):
    """A gzip stream cut mid-member must error, not silently parse the
    decompressed prefix (zlib reports truncation via gzerror, not a
    negative gzread)."""
    import gzip

    import pytest

    from fedrann_jax.io.native import pack_reads_native
    from fedrann_jax.sim import simulate_reads

    sim = simulate_reads(genome_length=40000, coverage=4,
                         mean_read_length=1500, seed=5)
    gz = str(tmp_path / "r.fasta.gz")
    with gzip.open(gz, "wt") as f:
        for n, s in zip(sim.names, sim.sequences):
            f.write(f">{n}\n{s}\n")
    data = open(gz, "rb").read()
    trunc = str(tmp_path / "trunc.fasta.gz")
    open(trunc, "wb").write(data[: len(data) // 2])
    with pytest.raises(ValueError):
        pack_reads_native(trunc, (2048,))


def test_malformed_fastq_fails_fast(tmp_path):
    """A stray extra line between FASTQ records must raise (the block
    parser detects a non-'@' record head mid-stream instead of buffering
    the rest of the file)."""
    import pytest

    from fedrann_jax.io.native import pack_reads_native

    bad = str(tmp_path / "bad.fastq")
    with open(bad, "w") as f:
        f.write("@r1\nACGTACGT\n+\nIIIIIIII\nEXTRA\n@r2\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError):
        pack_reads_native(bad, (2048,))

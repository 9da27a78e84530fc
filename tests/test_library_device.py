"""Device-resident library construction vs oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from fedrann_jax import oracle
from fedrann_jax.io.fastx import FastxRecord
from fedrann_jax.io.packing import pack_reads
from fedrann_jax.kmers.codec import (
    canonical_window_codes,
    sample_hash32,
    u64_to_words,
)
from fedrann_jax.kmers.library_device import build_library_on_device
from fedrann_jax.sim import simulate_reads


@pytest.mark.parametrize("k", [13, 21])
def test_sample_hash32_device_matches_oracle(k):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 1 << min(2 * k, 62), size=5000, dtype=np.uint64)
    seed = 602
    dev = np.asarray(sample_hash32(
        tuple(jnp.asarray(w) for w in u64_to_words(codes, k)), seed
    ))
    assert np.array_equal(dev, oracle.sample_hash32(codes, seed))


@pytest.mark.parametrize("k,fraction", [(13, 0.3), (21, 0.3), (13, 1.0)])
def test_build_library_on_device_matches_oracle(k, fraction):
    sim = simulate_reads(genome_length=8000, coverage=6, mean_read_length=900,
                         seed=5)
    packed = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(2048,),
    )
    canon_chunks = [
        canonical_window_codes(jnp.asarray(b.bases), k)[0]
        for b in packed.buckets
    ]
    lib_dev = build_library_on_device(canon_chunks, k, 2, fraction, seed=17)
    lib_orc = oracle.build_library(sim.sequences, k, 2, fraction, seed=17)
    assert np.array_equal(lib_dev.codes, lib_orc.codes)
    assert np.array_equal(lib_dev.counts, lib_orc.counts)


def test_build_library_cap_overflow_recovers():
    """An undersized capacity must trigger the uncapped rebuild, not drop."""
    sim = simulate_reads(genome_length=4000, coverage=4, mean_read_length=600,
                         seed=6)
    packed = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(1024,),
    )
    k = 11
    canon_chunks = [
        canonical_window_codes(jnp.asarray(b.bases), k)[0]
        for b in packed.buckets
    ]
    lib_dev = build_library_on_device(canon_chunks, k, 1, 1.0, seed=3, cap=16)
    lib_orc = oracle.build_library(sim.sequences, k, 1, 1.0, seed=3)
    assert np.array_equal(lib_dev.codes, lib_orc.codes)

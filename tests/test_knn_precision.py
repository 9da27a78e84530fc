"""Every distance product states its precision: knn_precision="fp32" lowers
each dot_general at HIGHEST (no TF32 on GPUs), "bf16" keeps bf16 operands
with f32 accumulation."""

from __future__ import annotations

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedrann_jax.knn import ivf, ooc, ring, topk
from fedrann_jax.parallel.mesh import make_mesh

N, D, K = 64, 16, 4


def _e(dtype=jnp.float32):
    rng = np.random.default_rng(0)
    return jnp.asarray(rng.standard_normal((N, D)), dtype)


def _lower_tiles(precision):
    return topk._knn_tiles_qc.lower(
        _e(), _e(), n_neighbors=K, query_tile=16, candidate_tile=32,
        precision=precision)


def _lower_ooc(precision):
    dt = jnp.bfloat16 if precision == "bf16" else jnp.float32
    carry_s = jnp.zeros((2, 32, K), jnp.float32)
    carry_i = jnp.zeros((2, 32, K), jnp.int32)
    return ooc._ooc_step.lower(
        carry_s, carry_i, _e(dt).reshape(2, 32, D), _e(dt), jnp.int32(0),
        jnp.int32(N), k=K, candidate_tile=32, precision=precision)


def _lower_ring(precision):
    mesh = make_mesh((4,))
    kernel, _ = ring._make_kernel(mesh, "ring", K, N, precision)
    return jax.jit(kernel).lower(_e())


def _lower_ivf(precision):
    member = jnp.tile(jnp.arange(N, dtype=jnp.int32).reshape(4, 16), 1)
    return ivf._ivf_search.lower(
        _e(), member, member, jnp.zeros_like(member), n_probes=1, k=K,
        precision=precision)


def _lower_ooc_assign(precision):
    return ooc._assign_block.lower(_e(), _e()[:8], precision=precision)


LOWERINGS = {"tiles": _lower_tiles, "ooc": _lower_ooc, "ring": _lower_ring,
             "ivf": _lower_ivf, "ooc_assign": _lower_ooc_assign}


def _dots(lowered):
    lines = [ln for ln in lowered.as_text().splitlines()
             if "dot_general" in ln]
    assert lines, "no dot_general in the lowered program"
    return lines


@pytest.mark.parametrize("name", sorted(LOWERINGS))
def test_fp32_products_are_highest(name):
    for ln in _dots(LOWERINGS[name]("fp32")):
        assert "HIGHEST" in ln, ln
        assert "bf16" not in ln, ln


@pytest.mark.parametrize("name", sorted(LOWERINGS))
def test_bf16_products_keep_bf16_operands(name):
    for ln in _dots(LOWERINGS[name]("bf16")):
        assert "HIGHEST" not in ln, ln
        operands = re.search(r"\((tensor<[^)]*)\)\s*->", ln).group(1)
        assert operands.count("bf16") == 2, ln
        assert re.search(r"->\s*tensor<[^>]*xf32>", ln), ln

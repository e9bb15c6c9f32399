"""The port's launch-overhead probe (``dynamo_tpu_torch/bench.py``) against
the JAX package's ``bench.py`` ``_pallas_dispatch_overhead_ms``.

The no-op kernel computes a copy of one [8, 128] f32 tile in both
packages: the JAX Pallas ``nop`` (interpreter mode) and the port's ``nop``
on a CPU tensor (its plain version) give the input back. The probe itself
times the card and has no CPU form: without a card it raises rather than
time the plain version. On the card, ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` run it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from dynamo_tpu_torch import bench


def _jax_nop(x):
    """The kernel of the JAX probe (``bench.py`` ``nop``), interpreted."""

    def nop(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    return pl.pallas_call(nop, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32), interpret=True)(x)


def test_nop_matches_the_jax_probe_kernel():
    x = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)
    before = bench.REF_CALLS
    got = bench.nop(torch.from_numpy(x))
    assert bench.REF_CALLS == before + 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax_nop(jnp.asarray(x))))
    assert got.data_ptr() != torch.from_numpy(x).data_ptr()  # a copy, not the input


def test_probe_measures_the_card_only():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            bench.dispatch_overhead_ms()
    with pytest.raises(ValueError, match="cuda or cpu"):
        bench.nop(torch.zeros((8, 128), device="meta"))

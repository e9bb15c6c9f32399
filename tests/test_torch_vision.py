"""The port's ViT (``dynamo_tpu_torch/engine/models/vision.py``) against the
JAX package's: the same numpy parameters (``params_from_numpy``) and
images through both ``encode``s, at ``tiny-vit`` and a narrow 2-layer
tower, f32 within rtol = atol = 2e-4 (tests/test_llama_model.py:65), and
a bf16 run held at the relative Frobenius bound the card's check uses
(2e-2) against JAX's f32 encode."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.models import vision as jvision
from dynamo_tpu_torch.engine.models import vision as tvision

NARROW = dict(image_size=28, patch_size=7, hidden_size=48, num_layers=2, num_heads=4, intermediate_size=96,
              lm_hidden_size=40)
CONFIGS = {"tiny-vit": (jvision.PRESETS["tiny-vit"], tvision.PRESETS["tiny-vit"]),
           "narrow": (jvision.VisionConfig(**NARROW), tvision.VisionConfig(**NARROW))}
TOL = 2e-4
BF16_REL = 2e-2


def _pair(name: str, seed: int = 1):
    jc, tc = CONFIGS[name]
    jp = jvision.init_params(jc, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    imgs = np.random.default_rng(seed).random((2, jc.image_size, jc.image_size, 3), dtype=np.float32)
    return jc, tc, jp, tree, imgs


def test_presets_match_jax():
    assert set(tvision.PRESETS) == set(jvision.PRESETS)
    for name, jc in jvision.PRESETS.items():
        assert dataclasses.asdict(tvision.PRESETS[name]) == dataclasses.asdict(jc)
        assert tvision.PRESETS[name].num_patches == jc.num_patches


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_f32_matches_jax(name):
    jc, tc, jp, tree, imgs = _pair(name)
    want = np.asarray(jvision.encode(jp, jc, jnp.asarray(imgs)))
    tp = tvision.params_from_numpy(tree, tc, device="cpu", dtype=torch.float32)
    got = tvision.encode(tp, tc, torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, tc.num_patches, tc.lm_hidden_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tvision.patchify(torch.from_numpy(imgs), tc.patch_size).numpy(),
                                  np.asarray(jvision.patchify(jnp.asarray(imgs), jc.patch_size)))


def test_encode_bf16_within_the_card_bound():
    jc, tc, jp, tree, imgs = _pair("tiny-vit")
    want = np.asarray(jvision.encode(jp, jc, jnp.asarray(imgs)))
    tp = tvision.params_from_numpy(tree, tc, device="cpu", dtype=torch.bfloat16)
    got = tvision.encode(tp, tc, torch.from_numpy(imgs)).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= BF16_REL


def test_init_params_seeded_shapes_and_refusals():
    tc = tvision.PRESETS["tiny-vit"]
    a = tvision.init_params(tc, torch.Generator().manual_seed(3), device="cpu", dtype=torch.float32)
    b = tvision.init_params(tc, torch.Generator().manual_seed(3), device="cpu", dtype=torch.float32)
    jp = jvision.init_params(jvision.PRESETS["tiny-vit"], jax.random.PRNGKey(0), dtype=jnp.float32)
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), a) == shapes
    assert all(torch.equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))
    assert float(a["layers"]["wq"].std()) == pytest.approx(tc.hidden_size**-0.5, rel=0.2)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["proj"] = tree["proj"][:, :3]
    with pytest.raises(ValueError, match="proj"):
        tvision.params_from_numpy(tree, tc, device="cpu")

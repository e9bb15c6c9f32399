"""The port on the card: the hand-written CUDA kernel against its plain
version, and the model's kernel path against the CPU path.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
torch and the port only (no JAX), so it also runs on a machine without
JAX; there the repo's ``tests/conftest.py`` (which imports JAX) is left
out::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine.attention import megakernel as mk
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays
from dynamo_tpu_torch.engine.models import llama
from dynamo_tpu_torch.engine.weights import init_params

pytestmark = pytest.mark.cuda

BS = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU or interpreter mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _step(seed, *, H, KVH, HD, chunk, prefix, decode_ctx, dead=0, tail=0):
    """A ragged step in ``mixed_step``'s layout: a chunk row over a paged
    prefix, then decode rows; page 0 is scratch with large values."""
    g = torch.Generator().manual_seed(seed)
    B = len(decode_ctx)
    prefixes = [prefix] + [c - 1 for c in decode_ctx]
    n_pages = [(p + BS - 1) // BS for p in prefixes]
    W = max(max(n_pages), 1) + tail
    NP = sum(n_pages) + 1
    ids = (torch.randperm(NP - 1, generator=g) + 1).to(torch.int32)
    tables = torch.zeros((1 + B, W), dtype=torch.int32)
    o = 0
    for r, n in enumerate(n_pages):
        tables[r, :n] = ids[o:o + n]
        o += n
    pages = [torch.randn((NP, BS, KVH, HD), generator=g) for _ in range(2)]
    for p in pages:
        p[0] = 1e4
    NQ = chunk + B
    s, d = torch.arange(chunk, dtype=torch.int32), torch.arange(B, dtype=torch.int32)
    meta = mk.build_meta(
        torch.cat([torch.zeros_like(s), 1 + d]),
        torch.tensor([prefix] * chunk + prefixes[1:], dtype=torch.int32),
        torch.cat([torch.zeros_like(s), chunk + d]),
        torch.cat([s + 1, chunk + d + 1]),
        torch.cat([s < chunk - dead, torch.ones(B, dtype=torch.bool)]),
    )
    q = torch.randn((NQ, H, HD), generator=g)
    ke, ve = torch.randn((NQ, KVH, HD), generator=g), torch.randn((NQ, KVH, HD), generator=g)
    return (q, ke, ve, pages[0], pages[1], tables, meta), KVH


STEPS = {
    "llama-3.2-1b": dict(H=32, KVH=8, HD=64, chunk=128, prefix=300, decode_ctx=[1, 16, 17, 33, 700]),
    "hd128": dict(H=32, KVH=8, HD=128, chunk=64, prefix=100, decode_ctx=[5, 64, 300]),
    "mqa": dict(H=8, KVH=1, HD=64, chunk=32, prefix=48, decode_ctx=[1, 2, 200]),
    "mha_edges": dict(H=4, KVH=4, HD=64, chunk=40, prefix=64, decode_ctx=[16, 17, 32], dead=9, tail=7),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(STEPS))
def test_kernel_matches_plain_version(cuda, name, dtype):
    host, kvh = _step(sum(map(ord, name)), **STEPS[name])
    args = tuple(t.to(cuda, dtype=dtype if t.is_floating_point() else t.dtype) for t in host)
    before = mk.KERNEL_LAUNCHES
    out = mk.ragged_paged_attention(*args, num_kv_heads=kvh, block_size=BS)
    ref = mk.ragged_paged_attention_ref(*args, num_kv_heads=kvh, block_size=BS)
    torch.cuda.synchronize()
    assert mk.KERNEL_LAUNCHES == before + 1
    live = args[6][4] != 0
    assert torch.all(out[~live] == 0)
    # f32: the same math in another summation order. bf16: the plain version
    # rounds p to bf16 before the PV product (≤ 2^-9·max|v|, with
    # max|v| < 5 here) and each output rounds once more.
    tol = 5e-5 if dtype == torch.float32 else 2**-9 * 5.0 + 2**-8 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_wrapper_refuses_unsupported_inputs(cuda):
    host, kvh = _step(1, **STEPS["mqa"])
    args = [t.to(cuda) for t in host]
    with pytest.raises(TypeError):
        mk.ragged_paged_attention(*(a.half() if a.is_floating_point() else a for a in args),
                                  num_kv_heads=kvh, block_size=BS)
    with pytest.raises(ValueError):
        mk.ragged_paged_attention(args[0], *args[1:3], args[3].cpu(), *args[4:], num_kv_heads=kvh, block_size=BS)


def test_model_kernel_path_matches_cpu_path(cuda):
    """``tiny`` in f32: a prefill and two decode steps on the card (kernel)
    and on the CPU (plain version) give the same logits."""
    cfg = get_config("tiny")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 255, size=40).astype(np.int32)
    table = np.arange(1, 5, dtype=np.int32)

    def run(dev):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        c = KvCacheArrays.create(cfg, 8, dtype=torch.float32, device=dev)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        padded = np.zeros(64, np.int32)
        padded[:36] = toks[:36]
        out = [llama.prefill(p, cfg, c.k, c.v, t(padded), 36, 0, t(table))[0][None]]
        for i in range(2):
            out.append(llama.decode(p, cfg, c.k, c.v, t(toks[36 + i:37 + i]), t(np.array([36 + i], np.int32)),
                                    t(table[None]), t(np.array([True])))[0])
        return torch.cat(out).cpu()

    before = mk.KERNEL_LAUNCHES
    on_card = run(cuda)
    assert mk.KERNEL_LAUNCHES - before == 3 * cfg.num_layers
    torch.testing.assert_close(on_card, run("cpu"), rtol=2e-4, atol=2e-4)

"""The port's disaggregated prefill/decode (``dynamo_tpu_torch/llm/disagg.py``)
against the JAX package's, on ``tiny`` (f32, CPU), over the port's runtime:

1. ``tests/test_disagg.py``'s cases: a remotely prefilled request decodes the
   aggregated engine's tokens (and the JAX engine's) in host and device
   mode (the device hand-over in process), with every export pulled and no
   block left held; a short prompt prefills locally under
   ``max_local_prefill_length``; a dead prefill pool falls back to local
   prefill and counts the degrade; ``prefill_first`` through the work queue
   matches aggregated, goes local at once with no queue worker, and backs
   off after a reply timeout; an export nobody pulls is reclaimed after its
   TTL; the conf reloads from the store.
2. A token-boundary split (``disagg_params.split_at`` and the load probe's
   ``max_prefill_tokens``): the pool prefills the head, the decode worker
   the rest, and the tokens are the aggregated ones.
3. The host pull's frames are byte-equal to the JAX ``KvExportService``'s
   for the same blocks (f32 and bf16), and each package's ``pull_kv_blocks``
   reads the other's.
4. The device plane between two processes (the CPU's shared memory in
   place of CUDA IPC): an offered stack is pulled bit-equal and released on
   the ack; the processes as an operator runs them (control plane, a
   ``--role prefill`` and a ``--role decode --kv-transfer device`` worker,
   the frontend) answer as one aggregated worker does.
The same pull through CUDA IPC runs on the card
(``tests/test_torch_cuda.py::test_cuda_ipc_pull_across_processes``).
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.engine import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.llm import disagg as jdisagg
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxDrt
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.transports import tcp as jtcp
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm import disagg
from dynamo_tpu_torch.llm.disagg import (
    DisaggDecodeHandler,
    DisaggRouter,
    DisaggRouterConf,
    KvExportService,
    PrefillQueueWorker,
)
from dynamo_tpu_torch.runtime import msgpack_codec
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports import tcp as ptcp

REPO = Path(__file__).resolve().parent.parent
TCFG = get_config("tiny")
JCFG = jax_config("tiny")
SCHED = dict(num_blocks=64, prefill_buckets=[16, 32, 64], decode_buckets=[1, 2, 4, 8], enable_prefix_caching=False)


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(7), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, device="cpu", dtype=torch.float32)


def build_engine(weights, **sched):
    return TorchEngine.build(EngineArgs(model="tiny", dtype="float32", device="cpu",
                                        scheduler=SchedulerConfig(**{**SCHED, **sched})), params=weights[1])


def req(tokens, max_tokens=6):
    return {"token_ids": tokens, "sampling_options": {"temperature": 0.0}, "stop_conditions": {"max_tokens": max_tokens}}


async def collect(engine_like, request, ctx=None):
    out, fin = [], None
    async for frame in engine_like.generate(request, ctx or Context()):
        data = frame.data if hasattr(frame, "data") else frame
        if data:
            out.extend(data.get("token_ids") or [])
            fin = data.get("finish_reason") or fin
    return out, fin


async def aggregated(weights, request):
    """(the port's aggregated tokens, the JAX engine's) for ``request``."""
    ref = build_engine(weights)
    try:
        mine, _ = await collect(ref, request)
    finally:
        await ref.stop()
    jeng = TpuEngine.build(JaxEngineArgs(model="tiny", dtype="float32", scheduler=JaxSchedulerConfig(**SCHED)),
                           params=weights[0])
    try:
        theirs = []
        async for frame in jeng.generate(request, JaxContext()):
            theirs.extend(frame.get("token_ids") or [])
    finally:
        await jeng.stop()
    return mine, theirs


async def setup_disagg(drt, weights, *, conf=None, kv_transfer="host", probe=None):
    """A prefill engine served on the wire (not ``local_engines``) with its
    export service, and a decode handler over it."""
    prefill_engine = build_engine(weights)
    decode_engine = build_engine(weights)
    prefill_ep = drt.namespace("disagg").component("prefill").endpoint("generate")
    handle = await prefill_ep.serve_endpoint(prefill_engine.generate, stats_handler=prefill_engine.stats_handler)
    kvx = KvExportService(drt, prefill_engine, handle.instance)
    await kvx.start()
    drt.local_engines.pop(handle.instance.instance_id)
    prefill_client = await prefill_ep.client()
    await prefill_client.wait_for_instances(1, timeout=5)
    router = DisaggRouter(drt, "tiny", conf=conf) if conf is not None else None
    handler = DisaggDecodeHandler(drt, decode_engine, prefill_client, router, kv_transfer=kv_transfer,
                                  pool_load_probe=probe)
    return handler, prefill_engine, decode_engine, kvx, handle


async def teardown(kvx, *engines):
    await kvx.stop()
    for e in engines:
        await e.stop()


# ---------------------------------------------------------------------------
# 1. tests/test_disagg.py's cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_transfer", ["host", "device"])
async def test_disagg_matches_aggregated(weights, kv_transfer):
    drt = await DistributedRuntime.detached()
    try:
        handler, pe, de, kvx, _ = await setup_disagg(drt, weights, kv_transfer=kv_transfer)
        taken = []
        for name in ("take_export", "take_export_device"):
            def wrap(fn, name=name):
                async def took(rid):
                    taken.append(name)
                    return await fn(rid)
                return took
            setattr(pe, name, wrap(getattr(pe, name)))
        prompt = list(range(20, 60))
        mine, theirs = await aggregated(weights, req(prompt))
        out, fin = await collect(handler, req(prompt))
        assert out == mine == theirs and fin == "length"
        assert handler.remote_prefills == 1 and handler.local_prefills == 0
        assert handler.degrade_disagg_to_colocated_total == 0
        assert pe.scheduler.allocator.num_active == 0 and not pe.scheduler._pending_exports
        assert (pe.scheduler.exports_total, pe.scheduler.exports_taken_total) == (1, 1)
        # Host mode pulled host pairs; device mode took the stack in process.
        assert taken == ["take_export" if kv_transfer == "host" else "take_export_device"]
        stats = handler.stats_handler()
        assert stats["remote_prefills"] == 1 and stats["split_prefills_total"] == 0
        assert "prefix_onboard_total" in stats
        await teardown(kvx, pe, de)
    finally:
        await drt.shutdown()


async def test_conditional_disagg_short_prompt_local(weights):
    drt = await DistributedRuntime.detached()
    try:
        handler, pe, de, kvx, _ = await setup_disagg(drt, weights, conf=DisaggRouterConf(max_local_prefill_length=100))
        await collect(handler, req(list(range(30))))
        assert (handler.local_prefills, handler.remote_prefills) == (1, 0)
        await collect(handler, req(list(range(120))))
        assert handler.remote_prefills == 1
        await teardown(kvx, pe, de)
    finally:
        await drt.shutdown()


async def test_prefill_pool_death_falls_back_to_local(weights):
    drt = await DistributedRuntime.detached()
    try:
        handler, pe, de, kvx, handle = await setup_disagg(drt, weights)
        await handle.stop()
        for _ in range(100):
            if not handler.prefill_client.instances:
                break
            await asyncio.sleep(0.02)
        out, fin = await collect(handler, req(list(range(40))))
        assert len(out) == 6 and fin == "length"
        assert handler.local_prefills == 1 and handler.remote_prefills == 0
        await teardown(kvx, pe, de)
    finally:
        await drt.shutdown()


async def test_failed_device_pull_degrades_and_counts(weights):
    """A device pull that fails (the export is gone) is not retried as a
    host copy: the request prefills locally and the degrade is counted."""
    drt = await DistributedRuntime.detached()
    try:
        handler, pe, de, kvx, _ = await setup_disagg(drt, weights, kv_transfer="device")

        async def gone(request_id):
            return None

        pe.take_export_device = gone
        pe.take_export = None  # a host pull would raise here
        prompt = list(range(20, 60))
        out, _ = await collect(handler, req(prompt))
        mine, _ = await aggregated(weights, req(prompt))
        assert out == mine
        assert handler.degrade_disagg_to_colocated_total == 1 and handler.local_prefills == 1
        await teardown(kvx, pe, de)
    finally:
        await drt.shutdown()


async def test_prefill_first_queue_matches_aggregated(weights):
    drt = await DistributedRuntime.detached()
    try:
        pe, de = build_engine(weights), build_engine(weights)
        prefill_ep = drt.namespace("disagg").component("prefill").endpoint("generate")
        handle = await prefill_ep.serve_endpoint(pe.generate, stats_handler=pe.stats_handler)
        kvx = KvExportService(drt, pe, handle.instance)
        await kvx.start()
        drt.local_engines.pop(handle.instance.instance_id)
        worker = PrefillQueueWorker(drt, pe, handle.instance)
        await worker.start()
        handler = DisaggDecodeHandler(drt, de, strategy="prefill_first", queue_reply_timeout_s=10.0,
                                      kv_transfer="host")
        prompt = list(range(20, 60))
        mine, _ = await aggregated(weights, req(prompt))
        out, fin = await collect(handler, req(prompt))
        assert out == mine and fin == "length"
        assert handler.remote_prefills == 1 and worker.jobs_served == 1
        assert pe.scheduler.allocator.num_active == 0
        await worker.stop()
        await teardown(kvx, pe, de)
    finally:
        await drt.shutdown()


async def test_prefill_first_no_workers_falls_back_local(weights):
    drt = await DistributedRuntime.detached()
    try:
        de = build_engine(weights)
        handler = DisaggDecodeHandler(drt, de, strategy="prefill_first", queue_reply_timeout_s=30.0)
        t0 = time.monotonic()
        out, fin = await collect(handler, req(list(range(40))))
        assert len(out) == 6 and fin == "length"
        assert time.monotonic() - t0 < 15.0
        assert (handler.remote_prefills, handler.local_prefills) == (0, 1)
        await de.stop()
    finally:
        await drt.shutdown()


async def test_prefill_first_backoff_after_timeout(weights):
    drt = await DistributedRuntime.detached()
    try:
        de = build_engine(weights)
        handler = DisaggDecodeHandler(drt, de, strategy="prefill_first", queue_reply_timeout_s=0.3)
        await drt.store.put("wq/prefill/workers/dead", b"")
        out, fin = await collect(handler, req(list(range(40))))
        assert len(out) == 6 and fin == "length"
        assert handler.remote_prefills == 1 and handler.degrade_disagg_to_colocated_total == 1
        assert handler._backoff_until > time.monotonic()
        out, _ = await collect(handler, req(list(range(40, 80))))
        assert len(out) == 6 and (handler.remote_prefills, handler.local_prefills) == (1, 2)
        await de.stop()
    finally:
        await drt.shutdown()


async def test_unpulled_export_reclaimed_after_ttl(weights):
    engine = build_engine(weights, export_ttl_s=0.3)
    engine.start()
    try:
        r = req(list(range(16)), max_tokens=1)
        r["disagg_params"] = {"do_remote_decode": True}
        await collect(engine, r)
        assert engine.scheduler._pending_exports and engine.scheduler.allocator.num_active > 0
        for _ in range(100):
            if not engine.scheduler._pending_exports:
                break
            await asyncio.sleep(0.05)
        assert not engine.scheduler._pending_exports and engine.scheduler.allocator.num_active == 0
        assert engine.scheduler.exports_expired_total == 1
    finally:
        await engine.stop()


async def test_disagg_conf_hot_reload():
    drt = await DistributedRuntime.detached()
    try:
        router = DisaggRouter(drt, "m1", conf=DisaggRouterConf(max_local_prefill_length=10))
        await router.start()
        assert router.prefill_remote(50, True) and not router.prefill_remote(5, True)
        assert not router.prefill_remote(50, False)
        await drt.store.put(DisaggRouterConf.store_key("chat", "m1"), b'{"max_local_prefill_length": 1000}')
        for _ in range(50):
            if router.conf.max_local_prefill_length == 1000:
                break
            await asyncio.sleep(0.02)
        assert not router.prefill_remote(50, True)
        await router.stop()
    finally:
        await drt.shutdown()


# ---------------------------------------------------------------------------
# 2. Token-boundary splits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["split_at", "probe"])
async def test_token_boundary_split_matches_aggregated(weights, how):
    """The pool prefills the first 32 tokens; the decode worker injects
    them, prefills the other 18 and samples its own first token."""
    drt = await DistributedRuntime.detached()
    try:
        probe = (lambda: {"max_prefill_tokens": 40}) if how == "probe" else None
        handler, pe, de, kvx, _ = await setup_disagg(drt, weights, kv_transfer="device", probe=probe)
        prompt = list(range(30, 80))
        r = req(prompt)
        if how == "split_at":
            r["disagg_params"] = {"split_at": 32}
        mine, _ = await aggregated(weights, req(prompt))
        out, fin = await collect(handler, r)
        assert out == mine and fin == "length"
        assert handler.split_prefills_total == 1 and handler.remote_prefills == 1
        assert de.scheduler.prefill_steps_total == 1  # the rest of the prompt, once
        assert pe.scheduler.allocator.num_active == 0
        await teardown(kvx, pe, de)
    finally:
        await drt.shutdown()


async def test_saturated_pool_and_saturated_local_take_the_ladder(weights):
    drt = await DistributedRuntime.detached()
    try:
        load = {"prefill_saturated": True}
        handler, pe, de, kvx, _ = await setup_disagg(drt, weights, conf=DisaggRouterConf(max_local_prefill_length=32),
                                                     probe=lambda: load)
        await collect(handler, req(list(range(20, 60))))
        assert (handler.local_prefills, handler.degrade_disagg_to_colocated_total) == (1, 1)
        load.clear()
        load["local_saturated"] = True
        await collect(handler, req(list(range(20))))
        assert (handler.remote_prefills, handler.degrade_colocated_to_disagg_total) == (1, 1)
        await teardown(kvx, pe, de)
    finally:
        await drt.shutdown()


# ---------------------------------------------------------------------------
# 3. Host frames on the JAX wire
# ---------------------------------------------------------------------------


class _FixedExport:
    """An engine stub whose export is the given blocks."""

    def __init__(self, blocks, prompt_len):
        self.blocks, self.prompt_len = blocks, prompt_len

    async def take_export(self, request_id):
        return self.blocks, [1, 2], self.prompt_len


async def _raw_frames(drt, subject, pack, request_id="rid-1"):
    """Publish a host pull to ``subject`` and collect the response frames'
    (header, body) as they arrive."""
    conn_info, pending = drt.tcp_server_handle().register()
    await drt.bus.publish(subject, pack({"request_id": request_id, "conn": conn_info.to_dict()}))
    frames = []
    try:
        async for frame in pending.frames():
            if frame.kind != "prologue":  # it names the stream, which differs
                frames.append((frame.kind, dict(frame.header), bytes(frame.body)))
    finally:
        drt.tcp_server_handle().unregister(conn_info.stream_id)
    return frames


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
async def test_host_frames_byte_equal_jax_and_interoperate(dtype):
    import msgpack

    rng = np.random.default_rng(4)
    ndt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    shape = (TCFG.num_layers, TCFG.block_size, TCFG.num_kv_heads, TCFG.head_dim)
    np_blocks = [tuple(rng.standard_normal(shape).astype(np.float32).astype(ndt) for _ in range(2)) for _ in range(3)]

    def to_t(a):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16) if ndt is not np.float32 \
            else torch.from_numpy(a.copy())

    t_blocks = [(to_t(k), to_t(v)) for k, v in np_blocks]
    jdrt, pdrt = await JaxDrt.detached(), await DistributedRuntime.detached()
    try:
        from dynamo_tpu.runtime.component import Instance as JaxInstance

        jinst = JaxInstance("ns", "prefill", "generate", 0xA1)
        pinst = disagg.Instance("ns", "prefill", "generate", 0xA1)
        jsvc = jdisagg.KvExportService(jdrt, _FixedExport(np_blocks, 40), jinst)
        psvc = KvExportService(pdrt, _FixedExport(t_blocks, 40), pinst)
        await jsvc.start()
        await psvc.start()
        jframes = await _raw_frames(jdrt, jdisagg.kvx_subject(jinst), lambda d: msgpack.packb(d, use_bin_type=True))
        pframes = await _raw_frames(pdrt, disagg.kvx_subject(pinst), msgpack_codec.packb)
        assert [f[0] for f in pframes] == ["data"] * 3 + ["complete"]
        assert pframes == jframes
        for (_, h, b), (_, jh, jb) in zip(pframes, jframes):
            assert ptcp.encode_frame(h, b) == jtcp.encode_frame(jh, jb)
        assert pframes[0][1]["dtype"] == dtype
        # Each package's pull reads the other's frames: the port's pull
        # decodes the JAX frames' bodies to the same blocks.
        got = [disagg.block_of_frame(h, b) for kind, h, b in jframes if kind == "data"]
        for (k, v), (tk, tv) in zip(got, t_blocks):
            assert torch.equal(k, tk) and torch.equal(v, tv)
        jgot = await jdisagg.pull_kv_blocks(jdrt, jinst, "rid-2")
        for (k, v), (nk, nv) in zip(jgot, np_blocks):
            assert k.tobytes() == nk.tobytes() and v.tobytes() == nv.tobytes()
        pgot = await disagg.pull_kv_blocks(pdrt, pinst, "rid-3")
        assert all(torch.equal(k, tk) for (k, _), (tk, _) in zip(pgot, t_blocks))
        await jsvc.stop()
        await psvc.stop()
    finally:
        await jdrt.shutdown()
        await pdrt.shutdown()


# ---------------------------------------------------------------------------
# 4. The device plane between processes
# ---------------------------------------------------------------------------

PRODUCER = textwrap.dedent("""
    import sys, base64, torch
    from dynamo_tpu_torch.llm.block_manager.device_transfer import get_plane
    from dynamo_tpu_torch.runtime import msgpack_codec
    dev = torch.device(sys.argv[1])
    k = torch.arange(65536, dtype=torch.float32, device=dev).reshape(4, 64, 256)
    v = (k * -0.5).to(torch.bfloat16)
    meta = get_plane().offer("req-x", [k, v])
    print(base64.b64encode(msgpack_codec.packb(meta)).decode(), flush=True)
    sys.stdin.readline()
    get_plane().release_offer("req-x")
    print("RELEASED", get_plane().offers, flush=True)
""")


def _pull_across_processes(device: str):
    import base64

    from dynamo_tpu_torch.llm.block_manager.device_transfer import get_plane

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    prod = subprocess.Popen([sys.executable, "-c", PRODUCER, device], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, env=env, cwd=str(REPO))
    try:
        meta = msgpack_codec.unpackb(base64.b64decode(prod.stdout.readline()))
        assert meta["pid"] == prod.pid and len(meta["tensors"]) == 2
        k, v = get_plane().pull(meta, torch.device(device))
        want = torch.arange(65536, dtype=torch.float32).reshape(4, 64, 256)
        assert torch.equal(k.cpu(), want) and torch.equal(v.cpu(), (want * -0.5).to(torch.bfloat16))
        prod.stdin.write("ack\n")
        prod.stdin.flush()
        assert prod.stdout.readline().split() == ["RELEASED", "0"]
        assert prod.wait(timeout=30) == 0
    finally:
        if prod.poll() is None:
            prod.kill()
            prod.wait()


def test_device_plane_pull_across_processes():
    _pull_across_processes("cpu")


def test_device_plane_refuses_its_own_handles():
    from dynamo_tpu_torch.llm.block_manager.device_transfer import DeviceTransferPlane

    plane = DeviceTransferPlane()
    meta = plane.offer("r", [torch.ones(4)])
    with pytest.raises(RuntimeError, match="own IPC handles"):
        plane.pull(meta, torch.device("cpu"))
    plane.release_offer("r")
    assert plane.offers == 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_line(proc, log: Path, needle: str, timeout_s: float) -> str:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for ln in log.read_text().splitlines():
            if needle in ln:
                return ln
        assert proc.poll() is None, log.read_text()[-3000:]
        time.sleep(0.05)
    raise TimeoutError(f"{needle!r} not seen: {log.read_text()[-3000:]}")


def test_cli_prefill_and_decode_workers(tmp_path):
    """``python -m dynamo_tpu_torch.control_plane``, a ``--role prefill`` and
    a ``--role decode --kv-transfer device --max-local-prefill-length 24``
    worker (``--device cpu``) and the frontend: a long prompt is prefilled
    remotely and pulled across the processes, a short one locally; both
    answers equal an aggregated worker's tokens, and every process exits 0
    on SIGTERM with its counters logged."""
    import http.client

    cp_port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), DYN_CONTROL_PLANE="tcp", DYN_CONTROL_PLANE_ADDRESS=f"127.0.0.1:{cp_port}",
               DYN_LOG="INFO")
    common = ["--device", "cpu", "--model", "tiny", "--dtype", "float32", "--num-blocks", "64"]
    procs = {}

    def start(name, *args):
        log = tmp_path / f"{name}.log"
        procs[name] = (subprocess.Popen([sys.executable, "-m", *args], env=env, cwd=str(REPO),
                                        stdout=open(log, "w"), stderr=subprocess.STDOUT), log)

    try:
        start("cp", "dynamo_tpu_torch.control_plane", "--host", "127.0.0.1", "--port", str(cp_port))
        _wait_line(*procs["cp"], "control plane ready", 60)
        start("prefill", "dynamo_tpu_torch.worker", *common, "--role", "prefill")
        start("decode", "dynamo_tpu_torch.worker", *common, "--role", "decode", "--kv-transfer", "device",
              "--max-local-prefill-length", "24")
        for name in ("prefill", "decode"):
            _wait_line(*procs[name], "worker ready", 120)
        start("front", "dynamo_tpu_torch.frontend", "--http-host", "127.0.0.1", "--http-port", "0",
              "--router-mode", "kv")
        line = _wait_line(*procs["front"], "frontend ready on", 120)
        port = int(line.split(" (")[0].rsplit(":", 1)[1])

        def complete(prompt: str) -> dict:
            deadline = time.monotonic() + 30
            while True:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
                conn.request("POST", "/v1/completions", json.dumps(
                    {"model": "tiny", "prompt": prompt, "max_tokens": 8, "temperature": 0.0}),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                raw = resp.read()
                conn.close()
                if resp.status == 200 or time.monotonic() > deadline:
                    assert resp.status == 200, raw
                    return json.loads(raw)
                time.sleep(0.2)

        long_p, short_p = "the prefill worker computes this prompt's KV", "short"
        answers = [complete(long_p), complete(short_p)]
        for name in ("front", "decode", "prefill", "cp"):
            proc, _ = procs[name]
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0, procs[name][1].read_text()[-3000:]
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def counters(name):
        (ln,) = [ln for ln in procs[name][1].read_text().splitlines() if "worker launch counters: " in ln]
        return json.loads(ln.split("worker launch counters: ", 1)[1])

    dec, pre = counters("decode"), counters("prefill")
    assert dec["disagg"]["remote_prefills"] == 1 and dec["disagg"]["local_prefills"] == 1
    assert dec["disagg"]["degrade_disagg_to_colocated_total"] == 0
    assert pre["steps"]["exports_total"] == pre["steps"]["exports_taken_total"] == 1
    assert pre["steps"]["exports_expired_total"] == 0
    assert dec["steps"]["prefill_steps_total"] == 1  # the short prompt only

    async def reference():
        # One aggregated engine with the workers' seeded weights, in process.
        from dynamo_tpu_torch import run

        args = run.parse_args(["in=http", "out=tiny", "--device", "cpu", "--dtype", "float32", "--num-blocks", "64",
                               "--http-host", "127.0.0.1", "--http-port", "0"])
        service, engine = run.build_service(args)
        await service.start()
        port_ = service.port
        try:
            def one(prompt):
                conn = http.client.HTTPConnection("127.0.0.1", port_, timeout=120)
                conn.request("POST", "/v1/completions", json.dumps(
                    {"model": "tiny", "prompt": prompt, "max_tokens": 8, "temperature": 0.0}),
                    {"Content-Type": "application/json"})
                raw = conn.getresponse().read()
                conn.close()
                return json.loads(raw)["choices"][0]["text"]

            return [await asyncio.to_thread(one, p) for p in (long_p, short_p)]
        finally:
            await service.stop()
            await engine.stop()

    assert [a["choices"][0]["text"] for a in answers] == asyncio.run(reference())

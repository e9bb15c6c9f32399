"""The port's stream perf capture (``llm/perf.py``) against the JAX
package's: ``record_stream`` / ``RecordedStream`` pass items through and
summarise the same shape, ``Recorder`` writes the same JSONL events,
``KvRecorder`` taps the same KV events off each package's event stream
into the same records, and ``analyze_logprobs`` gives the same numbers on
seeded logprobs. Tolerance: exact equality but the timestamps."""

from __future__ import annotations

import asyncio
import json

import numpy as np
import pytest

from dynamo_tpu.engine.kv_cache import KvEvent as JKvEvent
from dynamo_tpu.llm import perf as jperf
from dynamo_tpu.llm.kv_router.publisher import KvEventPublisher as JPublisher
from dynamo_tpu.runtime.distributed import DistributedRuntime as JDrt
from dynamo_tpu_torch.engine.kv_cache import KvEvent as PKvEvent
from dynamo_tpu_torch.llm import perf as pperf
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher as PPublisher
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime as PDrt


async def test_record_stream_passthrough_and_summary():
    async def gen():
        for i in range(5):
            await asyncio.sleep(0.002)
            yield {"token_ids": [i]}

    out = []
    for mod in (pperf, jperf):
        rec = mod.RecordedStream()
        items = [item async for item in mod.record_stream(gen(), rec)]
        out.append((items, rec.summarize(), [r.seq for r in rec.responses]))
    assert out[0][0] == out[1][0] == [{"token_ids": [i]} for i in range(5)]
    assert out[0][2] == out[1][2] == list(range(5))
    assert set(out[0][1]) == set(out[1][1]) and out[0][1]["responses"] == 5
    assert out[0][1]["ttft_s"] > 0 and out[0][1]["itl_p50_s"] > 0
    assert pperf.RecordedStream().summarize() == jperf.RecordedStream().summarize()
    assert pperf._quantile([3.0, 1.0, 2.0], 0.5) == jperf._quantile([3.0, 1.0, 2.0], 0.5)


def _strip(lines):
    return [{k: v for k, v in json.loads(ln).items() if k != "ts"} for ln in lines]


async def test_recorder_writes_the_same_jsonl(tmp_path):
    lines = []
    for mod in (pperf, jperf):
        path = tmp_path / f"{mod.__name__}.jsonl"
        rec = mod.Recorder(str(path))
        rec.start()
        for i in range(10):
            rec.emit("step", i=i, phase="decode" if i % 2 else "prefill")
        await rec.close()
        assert rec.events_written == 10
        lines.append(path.read_text().splitlines())
    assert _strip(lines[0]) == _strip(lines[1])


async def _kv_tap(drt_cls, pub_cls, ev_cls, mod, path):
    drt = await drt_cls.detached()
    try:
        rec = mod.Recorder(str(path))
        rec.start()
        tap = mod.KvRecorder(drt, "ns", "backend", rec)
        await tap.start()
        pub = pub_cls(drt, "ns", "backend", worker_id=7)
        pub.start()
        pub.publish(ev_cls(kind="stored", block_hashes=[1, 2, 3], parent_hash=None, ts=5.0))
        pub.publish(ev_cls(kind="removed", block_hashes=[2], ts=6.0))
        for _ in range(200):
            if rec.events_written >= 2:
                break
            await asyncio.sleep(0.01)
        await pub.stop()
        await tap.stop()
        await rec.close()
        return tap.stream_name, path.read_text().splitlines()
    finally:
        await drt.shutdown()


async def test_kv_recorder_taps_the_same_events(tmp_path):
    p_name, p_lines = await _kv_tap(PDrt, PPublisher, PKvEvent, pperf, tmp_path / "p.jsonl")
    j_name, j_lines = await _kv_tap(JDrt, JPublisher, JKvEvent, jperf, tmp_path / "j.jsonl")
    assert p_name == j_name
    assert _strip(p_lines) == _strip(j_lines) and len(p_lines) == 2
    assert json.loads(p_lines[0])["event"] == "kv_event" and json.loads(p_lines[0])["worker_id"] == 7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyze_logprobs_matches_jax(seed):
    lps = [float(x) for x in -np.abs(np.random.default_rng(seed).standard_normal(17 + seed))]
    assert pperf.analyze_logprobs(lps) == jperf.analyze_logprobs(lps)
    assert pperf.analyze_logprobs([]) == jperf.analyze_logprobs([])

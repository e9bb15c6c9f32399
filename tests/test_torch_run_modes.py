"""``python -m dynamo_tpu_torch.run``'s modes against the JAX package's
``run`` loop on the same ``tiny`` weights (f32, CPU), and the worker
decorators against the JAX package's:

- ``in=batch:<file>``: the records' ``prompt`` / ``text`` and
  ``max_tokens`` keys, one request at a time; the output file's records
  equal the JAX ``run``'s;
- ``in=text``: the stdin chat prints what the JAX ``run`` prints;
- ``out=dyn://dynamo.backend.generate``: the same batch through a push
  router to a port worker over the TCP control plane gives the same
  records, and the worker served every one;
- the CLI refuses ``out=mocker`` (ROADMAP Queue 1 item 20) and unknown
  modes;
- ``dynamo_worker`` / ``dynamo_endpoint``: a handler of each shape answers
  as under the JAX decorators, and a decorated worker serves an endpoint.
"""

import asyncio
import builtins
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamo_tpu.run as jrun
import dynamo_tpu.runtime.decorators as jdec
from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.engine import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch import run as prun
from dynamo_tpu_torch import worker as pworker
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.runtime import decorators as pdec
from dynamo_tpu_torch.runtime import dynamo_endpoint, dynamo_worker
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.push_router import PushRouter
from dynamo_tpu_torch.runtime.runtime import Runtime
from dynamo_tpu_torch.runtime.transports import tcp_control as ptcp

BUCKETS = dict(prefill_buckets=[32, 64, 128], decode_buckets=[1, 2, 4])
RECORDS = [{"prompt": "Tell me about the sea", "max_tokens": 7}, {"text": "abc"}, {"prompt": "z", "text": "unread"},
           {"prompt": "The quick brown fox jumps over the lazy dog, twice over", "max_tokens": 5}]
LINES = ["hello there", "and again", "x"]


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(jax_config("tiny"), jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), get_config("tiny"), device="cpu",
                                 dtype=torch.float32)


def write_records(path):
    path.write_text("\n".join(json.dumps(r) for r in RECORDS) + "\n\n")
    return path


def jax_args(mode, out_path=None, max_tokens=6):
    """The namespace the JAX ``run``'s ``main`` builds."""
    import argparse

    return argparse.Namespace(mode=mode, out="tiny", http_port=0, model_name=None, tokenizer=None, checkpoint=None,
                              dtype="float32", num_blocks=64, max_tokens=max_tokens, output=out_path, timeout=10.0)


def run_jax(monkeypatch, jp, mode, out_path=None):
    async def make_engine(out_spec, args, drt):
        return TpuEngine.build(JaxEngineArgs(model="tiny", dtype="float32", continuous_profiling=False,
                                             eos_token_ids=[0], scheduler=jsched.SchedulerConfig(
                                                 num_blocks=64, num_scheduler_steps=1, **BUCKETS)), params=jp), None

    monkeypatch.setattr(jrun, "make_engine", make_engine)
    asyncio.run(jrun.amain(jax_args(mode, out_path)))


def run_port(monkeypatch, tp, argv):
    orig = prun.build_service

    def build_service(args, **kw):
        return orig(args, params=tp, scheduler_config=SchedulerConfig(num_scheduler_steps=1, **BUCKETS))

    monkeypatch.setattr(prun, "build_service", build_service)
    asyncio.run(prun.amain(prun.parse_args(argv + ["--device", "cpu", "--dtype", "float32", "--num-blocks", "64",
                                                   "--max-tokens", "6"])))


def stdin(monkeypatch, lines):
    feed = list(lines)

    def fake_input(prompt=""):
        print(prompt, end="")
        if not feed:
            raise EOFError
        return feed.pop(0)

    monkeypatch.setattr(builtins, "input", fake_input)


def test_batch_records_equal_the_jax_run(weights, monkeypatch, tmp_path):
    jp, tp = weights
    src = write_records(tmp_path / "prompts.jsonl")
    run_jax(monkeypatch, jp, f"batch:{src}", str(tmp_path / "jax.jsonl"))
    run_port(monkeypatch, tp, [f"in=batch:{src}", "out=tiny", "--output", str(tmp_path / "port.jsonl")])
    mine, ref = (tmp_path / "port.jsonl").read_text(), (tmp_path / "jax.jsonl").read_text()
    assert mine == ref
    recs = [json.loads(line) for line in mine.splitlines()]
    assert [r["prompt"] for r in recs] == ["Tell me about the sea", "abc", "z", RECORDS[3]["prompt"]]
    assert all(r["output"] for r in recs)


def test_text_chat_prints_what_the_jax_run_prints(weights, monkeypatch, capsys):
    jp, tp = weights
    stdin(monkeypatch, LINES)
    run_jax(monkeypatch, jp, "text")
    ref = capsys.readouterr().out
    stdin(monkeypatch, LINES)
    run_port(monkeypatch, tp, ["in=text", "out=tiny"])
    mine = capsys.readouterr().out
    assert mine == ref
    assert mine.startswith("interactive chat with tiny; ctrl-d to exit\n> ") and mine.count("\n> ") == len(LINES) + 1


async def _dyn(tp, src, out_path, monkeypatch):
    server = ptcp.ControlPlaneServer(host="127.0.0.1", port=0)
    await server.start()
    # The run reaches the control plane named by the environment.
    monkeypatch.setenv("DYN_CONTROL_PLANE", "tcp")
    monkeypatch.setenv("DYN_CONTROL_PLANE_ADDRESS", f"127.0.0.1:{server.port}")
    conn = await ptcp.connect_control_plane(f"127.0.0.1:{server.port}")
    drt = DistributedRuntime(runtime=Runtime(), store=ptcp.TcpKvStore(conn), bus=ptcp.TcpPubSub(conn))
    await drt.start()
    engine = TorchEngine.build(EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=[0],
                                          scheduler=SchedulerConfig(num_blocks=64, num_scheduler_steps=1, **BUCKETS)),
                               params=tp)
    worker = await pworker.serve_engine(drt, engine, ModelDeploymentCard(name="tiny"))
    try:
        args = prun.parse_args([f"in=batch:{src}", "out=dyn://dynamo.backend.generate", "--output", str(out_path),
                                "--max-tokens", "6", "--model-name", "tiny"])
        await prun.amain(args)
        return engine.scheduler.request_total
    finally:
        await worker.stop(drain_timeout_s=1)
        await engine.stop()
        await drt.shutdown()
        await server.close()


def test_dyn_out_goes_through_a_port_worker(weights, monkeypatch, tmp_path):
    jp, tp = weights
    src = write_records(tmp_path / "prompts.jsonl")
    run_port(monkeypatch, tp, [f"in=batch:{src}", "out=tiny", "--output", str(tmp_path / "local.jsonl")])
    monkeypatch.setattr(prun, "build_service", None)  # out=dyn:// builds no engine
    served = asyncio.run(_dyn(tp, src, tmp_path / "dyn.jsonl", monkeypatch))
    assert served == len(RECORDS)
    assert (tmp_path / "dyn.jsonl").read_text() == (tmp_path / "local.jsonl").read_text()


@pytest.mark.parametrize("argv,msg", [(["in=text", "out=mocker"], "item 20"), (["in=grpc", "out=tiny"], "in=grpc"),
                                      (["in=text"], "in=")])
def test_cli_refuses_unported_and_unknown_modes(argv, msg, capsys):
    with pytest.raises(SystemExit):
        prun.parse_args(argv if len(argv) == 2 else argv + ["x"])
    assert msg in capsys.readouterr().err


# --- decorators ------------------------------------------------------------


async def gen_ctx(request, context):
    for i in range(request):
        yield i


async def gen_plain(request):
    yield request * 2


async def coro_value(request):
    return {"v": request}


async def coro_iter(request, context):
    return gen_ctx(request, context)


def sync_value(request):
    return request + 1


async def _drain(fn, request, ctx):
    return [x async for x in fn(request, ctx)]


@pytest.mark.parametrize("handler", [gen_ctx, gen_plain, coro_value, coro_iter, sync_value],
                         ids=lambda f: f.__name__)
def test_endpoint_decorator_answers_as_jax(handler):
    mine = asyncio.run(_drain(pdec.dynamo_endpoint(handler), 3, Context()))
    ref = asyncio.run(_drain(jdec.dynamo_endpoint(handler), 3, JaxContext()))
    assert mine == ref and mine
    assert (pdec.dynamo_endpoint(handler) is handler) == (jdec.dynamo_endpoint(handler) is handler)


def test_decorated_worker_serves_an_endpoint():
    @dynamo_endpoint
    async def echo(request):
        yield {"echo": request["x"]}

    @dynamo_worker(static=True)
    async def main(drt, n):
        ep = drt.namespace("ns").component("comp").endpoint("echo")
        await ep.serve_endpoint(echo)
        client = await ep.client()
        await client.wait_for_instances(1, timeout=5)
        router = PushRouter(client)
        out = [item.data for i in range(n) async for item in router.generate({"x": i}, Context())]
        await client.close()
        return isinstance(drt, DistributedRuntime), out

    is_drt, out = asyncio.run(main(3))
    assert is_drt and out == [{"echo": 0}, {"echo": 1}, {"echo": 2}]

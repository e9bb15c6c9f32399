"""The port's distributed runtime: process and cluster handles, the
namespace → component → endpoint hierarchy with discovery over the control
plane, the ``AsyncEngine`` shape and its ``Context``, the push router, and
the worker-writing decorators (the JAX package's ``runtime`` exports)."""

from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.runtime import Runtime
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.component import Namespace, Component, Endpoint, Instance
from dynamo_tpu_torch.runtime.push_router import PushRouter, RouterMode
from dynamo_tpu_torch.runtime.decorators import dynamo_worker, dynamo_endpoint

__all__ = [
    "AsyncEngine",
    "Context",
    "Runtime",
    "DistributedRuntime",
    "Namespace",
    "Component",
    "Endpoint",
    "Instance",
    "PushRouter",
    "RouterMode",
    "dynamo_worker",
    "dynamo_endpoint",
]

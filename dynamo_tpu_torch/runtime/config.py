"""Runtime configuration from environment variables, with the JAX
package's names: ``DYN_CONTROL_PLANE`` (``mem`` or ``tcp``),
``DYN_CONTROL_PLANE_ADDRESS``, ``DYN_CONTROL_PLANE_LEASE_TTL``,
``DYN_RUNTIME_SHUTDOWN_TIMEOUT``, ``DYN_NAMESPACE``, and the system status
server's (``runtime/health.py``) ``DYN_SYSTEM_ENABLED``, ``DYN_SYSTEM_PORT``,
``DYN_SYSTEM_HOST``, ``DYN_SYSTEM_USE_ENDPOINT_HEALTH_STATUS`` and
``DYN_SYSTEM_STARTING_HEALTH_STATUS``, which the worker's status server
follows (``worker.system_config``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class RuntimeConfig:
    # Graceful-shutdown drain timeout in seconds.
    shutdown_timeout_s: float = field(
        default_factory=lambda: float(os.environ.get("DYN_RUNTIME_SHUTDOWN_TIMEOUT", "30.0")))


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclass
class SystemConfig:
    """The system status server (``/health``, ``/live``, ``/metrics``,
    ``/debug/*``): the JAX package's ``DYN_SYSTEM_*`` surface."""

    enabled: bool = field(default_factory=lambda: _env_bool("DYN_SYSTEM_ENABLED", False))
    port: int = field(default_factory=lambda: int(os.environ.get("DYN_SYSTEM_PORT", "0")))
    host: str = field(default_factory=lambda: os.environ.get("DYN_SYSTEM_HOST", "0.0.0.0"))
    # /health follows every registered endpoint's health rather than the
    # process's.
    use_endpoint_health_status: bool = field(
        default_factory=lambda: _env_bool("DYN_SYSTEM_USE_ENDPOINT_HEALTH_STATUS", False))
    starting_health_status: str = field(
        default_factory=lambda: os.environ.get("DYN_SYSTEM_STARTING_HEALTH_STATUS", "notready"))


@dataclass
class ControlPlaneConfig:
    """Where the control plane (KV store + pub/sub) lives.

    ``mem`` — in-process (single-process deployments and tests).
    ``tcp`` — the built-in server (``python -m dynamo_tpu_torch.control_plane``).
    """

    backend: str = field(default_factory=lambda: os.environ.get("DYN_CONTROL_PLANE", "mem"))
    address: str = field(default_factory=lambda: os.environ.get("DYN_CONTROL_PLANE_ADDRESS", "127.0.0.1:6650"))
    lease_ttl_s: float = field(default_factory=lambda: float(os.environ.get("DYN_CONTROL_PLANE_LEASE_TTL", "10.0")))


@dataclass
class Config:
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    system: SystemConfig = field(default_factory=SystemConfig)
    control_plane: ControlPlaneConfig = field(default_factory=ControlPlaneConfig)
    namespace: str = field(default_factory=lambda: os.environ.get("DYN_NAMESPACE", "dynamo"))

    @classmethod
    def from_env(cls) -> "Config":
        return cls()

"""Runtime configuration from environment variables, with the JAX
package's names: ``DYN_CONTROL_PLANE`` (``mem`` or ``tcp``),
``DYN_CONTROL_PLANE_ADDRESS``, ``DYN_CONTROL_PLANE_LEASE_TTL``,
``DYN_RUNTIME_SHUTDOWN_TIMEOUT`` and ``DYN_NAMESPACE``. The system status
server's ``DYN_SYSTEM_*`` settings wait for ``--health-port`` (ROADMAP
Queue 1 item 18).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class RuntimeConfig:
    # Graceful-shutdown drain timeout in seconds.
    shutdown_timeout_s: float = field(
        default_factory=lambda: float(os.environ.get("DYN_RUNTIME_SHUTDOWN_TIMEOUT", "30.0")))


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
    control_plane: ControlPlaneConfig = field(default_factory=ControlPlaneConfig)
    namespace: str = field(default_factory=lambda: os.environ.get("DYN_NAMESPACE", "dynamo"))

    @classmethod
    def from_env(cls) -> "Config":
        return cls()

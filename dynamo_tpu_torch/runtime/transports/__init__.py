"""Transports: the control plane (a key-value store with leases and
watches, the etcd role; pub/sub with durable streams, the NATS role) and
the data plane (TCP response streaming). Copies of the JAX package's
``runtime/transports``, speaking the same wire."""

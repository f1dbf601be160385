"""Cluster-wide internal key-value store client.

Reference: ``python/ray/experimental/internal_kv.py`` — a thin client over
the GCS ``InternalKVManager``.  The collective layer uses it for
rendezvous and Train for its report transport.  Keys are strings, values
are bytes.
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch._private import worker as _worker_mod


def _w():
    return _worker_mod.global_worker()


def _internal_kv_initialized() -> bool:
    return _worker_mod.try_global_worker() is not None


def _internal_kv_put(key: str, value: bytes, overwrite: bool = True,
                     namespace: str = "default") -> bool:
    """Store ``value``; returns True if the key already existed."""
    resp = _w().rpc("kv_put", key=key, value=bytes(value),
                    overwrite=overwrite, namespace=namespace)
    return bool(resp["existed"])


def _internal_kv_get(key: str, namespace: str = "default") -> Optional[bytes]:
    return _w().rpc("kv_get", key=key, namespace=namespace)["value"]


def _internal_kv_exists(key: str, namespace: str = "default") -> bool:
    return _internal_kv_get(key, namespace=namespace) is not None


def _internal_kv_del(key: str, namespace: str = "default") -> bool:
    return bool(_w().rpc("kv_del", key=key, namespace=namespace)["deleted"])


def _internal_kv_list(prefix: str, namespace: str = "default") -> List[str]:
    return list(_w().rpc("kv_keys", prefix=prefix, namespace=namespace)["keys"])

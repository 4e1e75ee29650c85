"""Device-side ordered ragged gather over the mesh (SURVEY.md §5 comm
backend: "gather lengths with all_gather, then ragged gather of payload
bytes").

Every shard holds one ragged byte payload (a container block, or a block
range's concatenated blocks); the collective path all_gathers the
lengths, then all_gathers the padded payload rows, and host 0 trims each
row to its gathered length and concatenates in mesh order — the ordered
gather that would feed the writing host on a pod slice.

This module exercises the real XLA collective: `ragged_all_gather`
lowers to `all-gather` HLO over the mesh axis (asserted by
tests/test_gather.py on the 8-device virtual mesh). The gathered payload
lands replicated on every device (D x payload device memory), so the
collective only pays when the shards already live on the devices and the
device interconnect beats the host path. The container writer keeps the
host merge (`multihost.merge_containers`) as default; this path is the
drop-in for device-resident payloads.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def ragged_all_gather(mesh, shards: list[np.ndarray] | list[bytes],
                      return_parts: bool = False):
    """Gather D ragged uint8 payloads (one per device of the 1-D `mesh`)
    into their mesh-order concatenation via device collectives.

    Lengths ride an all_gather first (so every participant knows every
    trim point — the SURVEY §5 recipe), then the padded payload rows ride
    a second all_gather; the replicated result is trimmed host-side once.
    """
    axis = list(mesh.shape.keys())[0]
    D = int(mesh.devices.size)
    assert len(shards) == D, f"need one shard per device ({D})"
    rows = [np.frombuffer(s, dtype=np.uint8) if isinstance(s, bytes)
            else np.asarray(s, dtype=np.uint8) for s in shards]
    lens = np.array([r.size for r in rows], dtype=np.int32)
    Lpad = max(int(lens.max()) if D else 0, 1)
    mat = np.zeros((D, Lpad), dtype=np.uint8)
    for d, r in enumerate(rows):
        mat[d, : r.size] = r

    x = jax.device_put(mat, NamedSharding(mesh, P(axis, None)))
    l = jax.device_put(lens, NamedSharding(mesh, P(axis)))

    def gather(x, l):           # per-device view: x [1, Lpad], l [1]
        lens_all = jax.lax.all_gather(l, axis, tiled=True)       # [D]
        pay_all = jax.lax.all_gather(x, axis, tiled=True)        # [D, L]
        return pay_all, lens_all

    f = jax.jit(jax.shard_map(gather, mesh=mesh,
                              in_specs=(P(axis, None), P(axis)),
                              out_specs=(P(), P()), check_vma=False))
    pay_all, lens_all = f(x, l)
    pay_np = np.asarray(pay_all)
    lens_np = np.asarray(lens_all)
    parts = [pay_np[d, : int(lens_np[d])] for d in range(D)]
    if return_parts:
        return parts
    return b"".join(p.tobytes() for p in parts)


def gather_hlo(mesh) -> str:
    """Lowered HLO text of the gather step (for the collective assert)."""
    axis = list(mesh.shape.keys())[0]
    D = int(mesh.devices.size)

    def gather(x, l):
        return (jax.lax.all_gather(x, axis, tiled=True),
                jax.lax.all_gather(l, axis, tiled=True))

    f = jax.jit(jax.shard_map(gather, mesh=mesh,
                              in_specs=(P(axis, None), P(axis)),
                              out_specs=(P(), P()), check_vma=False))
    x = jax.ShapeDtypeStruct((D, 64), jnp.uint8)
    l = jax.ShapeDtypeStruct((D,), jnp.int32)
    return f.lower(x, l).compile().as_text()

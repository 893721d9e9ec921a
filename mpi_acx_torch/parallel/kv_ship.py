"""Per-layer KV shipping over host-plane partitioned channels (the JAX
package's ``parallel/kv_ship.py``).

The disaggregated-serving handoff (models/disagg.py): a prefill rank maps
one request's quantized KV cache, [L, prompt_bucket, H, D] int8 codes plus
their f32 scales, onto one partitioned send with L partitions, one per
transformer layer. The prefill publishes partition l with MPIX_Pready as
soon as layer l's K/V are on the host, while later layers still compute;
the decode rank polls MPIX_Parrived per layer and splices arrivals into its
cache.

Wire form: int8 codes and f32 scales are the only form KV takes on the
wire. A partition packs ``[k codes | v codes | k scales | v scales]``
contiguously, codes int8 [bucket, H, D] and scales f32 [bucket, H, 1]
(ops/kvquant.py's per-(position, head) layout), so every partition has the
same size. Partition index == layer index. The layout is a contract shared
with the JAX package (docs/MIGRATION.md, "KV-handoff partition layout"):
ranks of either package meet on one wire.

Channels are persistent: MPIX_Psend_init once per (peer, bucket), restarted
per request with MPIX_Start, so the next handoff reuses the channel, its
host staging rows (numpy uint8, which the binding reads in place) and its
flag slots.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

# Host-plane tags of the handoff. A KV round takes one tag per prompt
# bucket (log2-indexed: channels of different buckets are distinct
# persistent requests and must not share a (peer, tag) stream); the
# descriptors' tags sit beside them.
KV_TAG_BASE = 7100
DESC_HDR_TAG = 7001
DESC_FIN_TAG = 7002


def kv_tag(bucket: int) -> int:
    """Wire tag of the KV channel of a (power-of-two) prompt bucket."""
    if bucket <= 0 or bucket & (bucket - 1):
        raise ValueError(f"bucket {bucket} is not a power of two")
    return KV_TAG_BASE + bucket.bit_length()


def layer_part_bytes(bucket: int, heads: int, head_dim: int) -> int:
    """Bytes of one layer partition: k and v int8 codes plus k and v f32
    per-(position, head) scales."""
    codes = bucket * heads * head_dim
    scales = bucket * heads * 4
    return 2 * codes + 2 * scales


def _host(a) -> np.ndarray:
    """A contiguous numpy view of a CPU tensor or array (no copy when it
    is already contiguous)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise TypeError(f"KV codes on {a.device}: copy them to the host "
                            "before packing")
        a = a.numpy()
    return np.ascontiguousarray(a)


def pack_layer(row: np.ndarray, kq, ks, vq, vs) -> None:
    """Pack one layer's quantized K/V (CPU tensors or numpy arrays) into
    staging row ``row`` (uint8, ``layer_part_bytes`` long). The wire rule
    is enforced here: codes must already be int8 and scales f32; a bf16
    tensor at this point is a bug upstream, not something to quantize
    quietly at the wire."""
    kq, ks, vq, vs = (_host(a) for a in (kq, ks, vq, vs))
    assert kq.dtype == np.int8 and vq.dtype == np.int8, \
        (kq.dtype, vq.dtype, "wire form is int8 codes")
    assert ks.dtype == np.float32 and vs.dtype == np.float32, \
        (ks.dtype, vs.dtype, "wire form is f32 scales")
    o = 0
    for arr in (kq, vq, ks, vs):
        b = arr.reshape(-1).view(np.uint8)
        row[o:o + b.size] = b
        o += b.size
    assert o == row.size, (o, row.size)


def unpack_layer(row: np.ndarray, bucket: int, heads: int, head_dim: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of :func:`pack_layer`: staging row -> (kq, ks, vq, vs)
    numpy copies (the row is reused by the next round), codes [bucket, H,
    D] int8 and scales [bucket, H, 1] f32."""
    nc = bucket * heads * head_dim
    ns = bucket * heads * 4
    kq = row[:nc].view(np.int8).reshape(bucket, heads, head_dim).copy()
    vq = row[nc:2 * nc].view(np.int8).reshape(bucket, heads, head_dim).copy()
    o = 2 * nc
    ks = row[o:o + ns].view(np.float32).reshape(bucket, heads, 1).copy()
    vs = row[o + ns:o + 2 * ns].view(np.float32).reshape(bucket, heads,
                                                         1).copy()
    return kq, ks, vq, vs


@dataclass(frozen=True)
class ChannelGeom:
    """One persistent channel's key: what fixes its partition size and
    count."""

    peer: int
    bucket: int
    n_layers: int
    heads: int
    head_dim: int

    @property
    def part_bytes(self) -> int:
        return layer_part_bytes(self.bucket, self.heads, self.head_dim)


class _Channel:
    """A persistent L-partition channel to or from one peer: its staging
    rows, its request and whether a round is open."""

    def __init__(self, rt, geom: ChannelGeom, init):
        self.rt = rt
        self.geom = geom
        self.staging = np.zeros((geom.n_layers, geom.part_bytes), np.uint8)
        self.req = init(self.staging.reshape(-1), geom.n_layers, geom.peer,
                        kv_tag(geom.bucket))
        self.open_round = False

    def begin(self) -> None:
        assert not self.open_round, "previous handoff round still open"
        self.rt.start(self.req)
        self.open_round = True

    def finish(self):
        try:
            return self.rt.wait_partitioned(self.req)
        finally:
            self.open_round = False

    def close(self) -> None:
        self.rt.request_free(self.req)


class _SendChannel(_Channel):
    """One persistent L-partition send channel to one decode peer."""

    def __init__(self, rt, geom: ChannelGeom):
        super().__init__(rt, geom, rt.psend_init)
        self.published = 0

    def begin(self) -> None:
        super().begin()
        self.published = 0

    def publish(self, layer: int, kq, ks, vq, vs) -> None:
        """Stage layer ``layer``'s quantized K/V and Pready its partition,
        as soon as the layer's prefill is done, while later layers run."""
        pack_layer(self.staging[layer], kq, ks, vq, vs)
        self.rt.pready(layer, self.req)
        self.published += 1

    def abort_fill(self) -> None:
        """Pready every partition not yet published, with whatever its
        staging row holds (stale bytes: the receiver discards the
        handoff). Completing the round keeps the persistent channel
        restartable after a failure mid-handoff."""
        for layer in range(self.published, self.geom.n_layers):
            self.rt.pready(layer, self.req)
        self.published = self.geom.n_layers


class _RecvChannel(_Channel):
    """One persistent L-partition receive channel from the prefill peer."""

    def __init__(self, rt, geom: ChannelGeom):
        super().__init__(rt, geom, rt.precv_init)

    def poll(self, layer: int) -> bool:
        """MPIX_Parrived on partition ``layer``. A partition completed with
        an error (the peer died mid-ship) reads arrived too; the error
        surfaces in :meth:`finish`."""
        return self.rt.parrived(self.req, layer)

    def take(self, layer: int):
        """An arrived layer unpacked into (kq, ks, vq, vs) host arrays."""
        g = self.geom
        return unpack_layer(self.staging[layer], g.bucket, g.heads,
                            g.head_dim)


class _Channels:
    """Persistent channels of one direction, keyed by (peer, bucket)."""

    _kind = None

    def __init__(self, rt, n_layers: int, heads: int, head_dim: int):
        self.rt = rt
        self.n_layers = n_layers
        self.heads = heads
        self.head_dim = head_dim
        self._chans: Dict[Tuple[int, int], _Channel] = {}

    def channel(self, peer: int, bucket: int):
        key = (peer, bucket)
        if key not in self._chans:
            self._chans[key] = self._kind(
                self.rt, ChannelGeom(peer, bucket, self.n_layers,
                                     self.heads, self.head_dim))
        return self._chans[key]

    def close(self) -> None:
        for ch in self._chans.values():
            ch.close()
        self._chans.clear()


class KvShipper(_Channels):
    """Prefill side: persistent per-(peer, bucket) send channels."""

    _kind = _SendChannel


class KvReceiver(_Channels):
    """Decode side: persistent per-(peer, bucket) receive channels."""

    _kind = _RecvChannel

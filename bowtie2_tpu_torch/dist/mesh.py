"""The data mesh: whole batches over several devices, the index on each.

Port of bowtie2_tpu/dist/mesh.py. The JAX package replicates the index on
every device of a `data` axis and shards each batch's leading dimension
over it, one global computation. Here the aligner sends whole batches to
the mesh's devices in turn and collects them in order
(pipeline/align.py `BatchAligner(mesh=)`): a batch computes on its
device exactly what it computes alone, so the output is byte-identical to
a one-device run by construction, and splitting a batch (which would move
the fused DP budget and the overflow decisions) never happens.
`shard_batch` splits a batch's leading dimension for callers that want
the JAX package's layout.
"""

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from bowtie2_tpu_torch.index.fmindex import FMHalf, FMIndex

AXES = ("data", "shard")


class Mesh(NamedTuple):
    """Devices on one axis: "data" (batches) or "shard" (index tables). A
    device may repeat: ["cuda:0"] * 4 runs four shards, or four batch
    turns, on one card."""
    devices: Tuple[torch.device, ...]
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)


def device_key(device) -> torch.device:
    """A device with its index: "cuda" is the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None, axis: str = "data") -> Mesh:
    """A mesh over `devices` (default: every CUDA card; raises without
    one), cut to the first n_devices."""
    if axis not in AXES:
        raise ValueError(f"mesh axis {axis!r}: one of {AXES}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh takes the CUDA cards by default and none is "
                "available; pass devices=['cpu', ...] explicitly")
        devices = [f"cuda:{k}" for k in range(torch.cuda.device_count())]
    devs = tuple(device_key(d) for d in devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs a device")
    return Mesh(devs, axis)


def _half_to(h: Optional[FMHalf], device) -> Optional[FMHalf]:
    if h is None:
        return None
    return h._replace(**{f: getattr(h, f).to(device) for f in (
        "fm_blocks", "fchr", "ftab", "mark_rows", "offs")
        + (("occ_cp64",) if h.i64 else ())})


def index_to(idx: FMIndex, device) -> FMIndex:
    """A copy of a device index on another device."""
    return idx._replace(fw=_half_to(idx.fw, device),
                        bw=_half_to(idx.bw, device),
                        ref_words=idx.ref_words.to(device),
                        refn_words=idx.refn_words.to(device),
                        ref_cum=idx.ref_cum.to(device))


def replicate_index(idx: FMIndex, mesh: Mesh) -> Dict[torch.device, FMIndex]:
    """One copy of the index on each distinct device of the mesh (the
    given copy where it already lies there)."""
    out: Dict[torch.device, FMIndex] = {}
    here = device_key(idx.ref_words.device)
    for d in mesh.devices:
        if d not in out:
            out[d] = idx if d == here else index_to(idx, d)
    return out


def shard_batch(arrays, mesh: Mesh):
    """The leading dimension of each tensor split into mesh.size parts
    (the first ones longer by one where it does not divide), part k on
    mesh.devices[k]: [[part k of each array] for k]."""
    parts = [torch.tensor_split(a, mesh.size) for a in arrays]
    return [[p[k].to(d) for p in parts] for k, d in enumerate(mesh.devices)]

"""The cluster model (the counterpart of
``paddle_tpu/distributed/auto_parallel/cluster.py``): per-card peak rate
and memory and the link bandwidths, which the cost model
(:mod:`...cost_model.parallel_cost`) reads.

The fields keep the JAX package's names, so ``to_dict()`` and the cost
model read the same keys; on NVIDIA hardware they mean:

 - ``num_chips``: cards; ``device_kind``: ``torch.cuda.get_device_name``;
 - ``peak_flops``: dense bf16 tensor-core FLOP/s a card;
 - ``hbm_bytes``: a card's memory (``total_memory`` when detected);
 - ``ici_bandwidth``: NVLink, bytes/s a card in one direction (the links
   inside a host, as ICI is inside a TPU slice);
 - ``dcn_bandwidth``: the network between hosts, bytes/s a card (one
   400 Gb/s InfiniBand NIC a card, as an HGX H100 host has);
 - ``chips_per_host``: cards in one NVLink domain;
 - ``num_slices``: hosts (NVLink inside one, the network across).

``CHIP_SPECS`` (peak bf16 FLOP/s, memory bytes, NVLink bytes/s a
direction, cards a host) are datasheet figures: the H100 SXM5 989
TFLOP/s dense bf16, 80 GB, NVLink 4 900 GB/s both directions (450 one
way), 8 in an HGX host (NVIDIA H100 Tensor Core GPU datasheet; the same
989 TFLOP/s is the bound ``chip_smoke.py`` uses); H100 PCIe 756 TFLOP/s
and PCIe 5 x16 (64 GB/s); H200 SXM 989 TFLOP/s, 141 GB; A100 SXM 312
TFLOP/s, 80 GB, NVLink 3 600 GB/s both ways.  ``cpu`` is for the tests.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

__all__ = ["Cluster", "CHIP_SPECS"]

CHIP_SPECS = {
    "NVIDIA H100": (989e12, 80e9, 450e9, 8),
    "NVIDIA H100 PCIe": (756e12, 80e9, 64e9, 8),
    "NVIDIA H200": (989e12, 141e9, 450e9, 8),
    "NVIDIA A100": (312e12, 80e9, 300e9, 8),
    "cpu": (1e12, 8 << 30, 50e9, 1),
}
#: the network between hosts, bytes/s a card (a 400 Gb/s NIC)
DCN_BANDWIDTH = 50e9


@dataclass
class Cluster:
    num_chips: int = 1
    device_kind: str = "NVIDIA H100"
    peak_flops: float = 989e12
    hbm_bytes: int = int(80e9)
    ici_bandwidth: float = 450e9
    dcn_bandwidth: float = DCN_BANDWIDTH
    chips_per_host: int = 8
    num_slices: int = 1
    extras: dict = field(default_factory=dict)

    @staticmethod
    def spec_of(kind: str) -> tuple:
        """``CHIP_SPECS``' entry for a device name (the longest key it
        starts with), ``cpu``'s when none matches."""
        for k in sorted(CHIP_SPECS, key=len, reverse=True):
            if kind.lower().startswith(k.lower()):
                return CHIP_SPECS[k]
        return CHIP_SPECS["cpu"]

    @classmethod
    def auto_detect(cls, devices=None):
        """This host's cards from ``torch.cuda``: their name, count and
        memory (``devices``: card indices, all by default); the CPU entry
        when there is no card."""
        import torch
        if not torch.cuda.is_available():
            peak, hbm, ici, cph = CHIP_SPECS["cpu"]
            return cls(num_chips=1, device_kind="cpu", peak_flops=peak,
                       hbm_bytes=hbm, ici_bandwidth=ici, chips_per_host=cph)
        idx = list(range(torch.cuda.device_count())) if devices is None \
            else [int(getattr(d, "index", d) or 0) for d in devices]
        props = torch.cuda.get_device_properties(idx[0])
        kind = props.name
        peak, _, ici, _ = cls.spec_of(kind)
        return cls(num_chips=len(idx), device_kind=kind, peak_flops=peak,
                   hbm_bytes=int(props.total_memory), ici_bandwidth=ici,
                   chips_per_host=len(idx))

    def bandwidth(self, degree):
        """The bandwidth a collective over ``degree`` cards sees: NVLink
        when the group fits in one host, else the network's, times the
        hosts it spans, at most NVLink's."""
        if degree <= 1:
            return self.ici_bandwidth
        per_slice = max(self.num_chips // max(self.num_slices, 1), 1)
        if degree <= per_slice:
            return self.ici_bandwidth
        slices = (degree + per_slice - 1) // per_slice
        return min(self.ici_bandwidth, self.dcn_bandwidth * slices)

    def to_dict(self):
        return asdict(self)

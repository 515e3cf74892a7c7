"""Target hardware constants: the NVIDIA H100 parts' published dense rates
(the port of ``src/repro/roofline/hw.py``, which holds a TPU's).

Figures from NVIDIA's H100 data sheet, dense (no sparsity), at each part's
full power limit: matrix products in bf16 / fp16 on the tensor cores, fp32
on the CUDA cores (the port runs no TF32), fp64 on the tensor cores; HBM
bytes/s and capacity; the NVLink rate one way (half the data sheet's
bidirectional figure)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class HWSpec:
    name: str
    peak_flops_bf16: float     # per card, bf16 / fp16 tensor cores
    peak_flops_fp32: float     # per card, fp32 CUDA cores
    peak_flops_fp64: float     # per card, fp64 tensor cores
    hbm_bw: float              # bytes/s per card
    link_bw: float             # NVLink bytes/s per card, one way
    hbm_bytes: float           # capacity per card

    def peak_flops(self, dtype: str) -> float:
        """The peak FLOP/s of a product class: ``"bf16"``, ``"fp32"`` or
        ``"fp64"`` (the keys of ``OpCost.flops``)."""
        return {"bf16": self.peak_flops_bf16, "fp32": self.peak_flops_fp32,
                "fp64": self.peak_flops_fp64}[dtype]


H100_SXM = HWSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    peak_flops_fp32=67e12,
    peak_flops_fp64=67e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80e9,
)

H100_NVL = HWSpec(
    name="h100-nvl",
    peak_flops_bf16=835e12,
    peak_flops_fp32=60e12,
    peak_flops_fp64=60e12,
    hbm_bw=3.9e12,
    link_bw=300e9,
    hbm_bytes=94e9,
)

H100_PCIE = HWSpec(
    name="h100-pcie",
    peak_flops_bf16=756e12,
    peak_flops_fp32=51.2e12,
    peak_flops_fp64=51e12,
    hbm_bw=2.0e12,
    link_bw=300e9,
    hbm_bytes=80e9,
)


def spec_for(device_name: str) -> HWSpec:
    """The spec of a card by its name (``torch.cuda.get_device_name``):
    the PCIe or NVL part where the name says so, else the SXM part."""
    if "PCIe" in device_name:
        return H100_PCIE
    if "NVL" in device_name:
        return H100_NVL
    return H100_SXM

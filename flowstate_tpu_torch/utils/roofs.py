"""The card's roofs and the matmul FLOP count, in one place.

Port of ``flowstate_tpu/utils/roofs.py``.  The tools and ``chip_smoke.py``
divide by the constants and roofs here, so a recalibration cannot leave a
copy behind.  The JAX names and their counterparts:

* ``HBM_ROOF`` (:40): ``PEAK_BYTES_PER_S``, the H100's published HBM rate;
* ``vpu_roof`` (:57): ``fp32_roof``, the fp32 issue-rate plateau that the
  probe K3 (``csrc/issue_rate.cu``) calibrates through
  ``tools/n_scaling.py`` into ``results/n_scaling_torch.json``, the
  published float32 peak where that file is absent or another card's;
* ``mxu_roof`` (:66), ``calibrate_mxu_roof`` (:75): ``matmul_roof`` and
  ``calibrate_matmul_roof``, a chain of square ``torch.matmul``s timed by
  CUDA events in float32 (TF32 off, as the flows run) and in bf16, kept
  in ``results/evidence/matmul_roof_torch.json`` with the card's name and
  power limit.  A library product is right here: it calibrates a roof and
  ports no kernel;
* a calibration counts only for the card that made it: both files name
  their card as ``tools/common.py::card_fields`` gives it, and a roof is
  read from a file only where that is the name and power limit the card
  has now; otherwise, on the CPU and without a card, the published peak
  stands in;
* ``dot_flops`` (:147): ``matmul_flops``, 2 M N K for every product a
  call runs (batched ones too), counted by
  ``torch.utils.flop_counter.FlopCounterMode`` from the shapes; under
  autograd it counts the backward's products as well;
* ``split_cost`` (:180), ``combine_loop_cost`` (:213): none.  They read
  XLA's compiled cost model, which eager PyTorch does not have, and XLA
  counts a scanned body once (R17); the port counts every product it runs.

Nothing here runs at import; the calibration needs a card.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Union

import torch

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the 700 W
# power limit: float32 outside the tensor cores, TF32 and bf16 on them,
# and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# tools/n_scaling.py's default output, run from the repository's root
N_SCALING_PATH = os.path.join(REPO_ROOT, "results", "n_scaling_torch.json")
MATMUL_ROOF_PATH = os.path.join(REPO_ROOT, "results", "evidence",
                                "matmul_roof_torch.json")

# the products' peak by the dtype they run in (the port's float32
# products run without TF32)
_PEAKS = {"float32": PEAK_FP32_FLOPS, "bfloat16": PEAK_BF16_FLOPS}
DType = Union[torch.dtype, str, None]


def dtype_name(dtype: DType) -> str:
    """``"float32"`` or ``"bfloat16"`` for a torch dtype, its name, or
    None (a flow's ``compute_dtype`` unset: float32)."""
    name = "float32" if dtype is None else str(dtype).replace("torch.", "")
    if name not in _PEAKS:
        raise ValueError(f"no roof for dtype {dtype}")
    return name


def peak_flops(dtype: DType = torch.float32) -> float:
    """The published peak of the products in ``dtype``."""
    return _PEAKS[dtype_name(dtype)]


def _card_rate(path: str, key: str, device):
    """``key`` of the JSON at ``path`` where this card wrote it: the file's
    ``device`` is the card's name and power limit (``card_fields``) as
    ``device`` has them now.  None on the CPU or without a card, where the
    file is absent or another card's, or where it holds no ``key``."""
    from flowstate_tpu_torch.tools.common import card_fields

    device = torch.device(device)
    if (device.type != "cuda" or not torch.cuda.is_available()
            or not os.path.exists(path)):
        return None
    with open(path) as f:
        data = json.load(f)
    if data.get("device") != card_fields(device) or data.get(key) is None:
        return None
    return float(data[key])


def fp32_roof(device="cuda") -> float:
    """K3's calibrated fp32 plateau (ops/s, an FMA counting two) from this
    card's n-scaling output at ``N_SCALING_PATH``, else the published
    float32 peak."""
    rate = _card_rate(N_SCALING_PATH, "fp32_ops_per_s", device)
    return PEAK_FP32_FLOPS if rate is None else rate


def matmul_roof(dtype: DType = torch.float32, device="cuda") -> float:
    """The matmul roof in ``dtype`` (FLOP/s, 2 M N K a product) that this
    card's calibration at ``MATMUL_ROOF_PATH`` holds, else the published
    peak of that dtype."""
    rate = _card_rate(MATMUL_ROOF_PATH, f"{dtype_name(dtype)}_flops_per_s",
                      device)
    return peak_flops(dtype) if rate is None else rate


def calibrate_matmul_roof(dim: int = 4096, dtype: DType = torch.float32,
                          timed_calls: int = 8, device="cuda") -> float:
    """The delivered FLOP/s of square matmuls on the card.

    Four (dim, dim) products chained, run twice to warm up, then
    ``timed_calls`` times between two CUDA events.  float32 runs at the
    highest matmul precision (no TF32), as the port's flows do; bf16 on
    the tensor cores.  The rate joins ``MATMUL_ROOF_PATH`` under
    ``<dtype>_flops_per_s`` beside the card's name and power limit; a
    file that another card wrote is replaced, not joined.  Raises without
    a card: a roof is the card's."""
    from flowstate_tpu_torch.tools.common import card_fields

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"a roof is the card's: calibrate on a CUDA "
                         f"device, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device to calibrate a roof on")
    name = dtype_name(dtype)
    dt = getattr(torch, name)
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(dim, dim, generator=g, device=device, dtype=dt)
    b = torch.randn(dim, dim, generator=g, device=device, dtype=dt) / dim ** 0.5

    def chain(x):
        for _ in range(4):
            x = x @ b
        return x

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        out = chain(chain(a))
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(timed_calls):
            out = chain(out)
        end.record()
        torch.cuda.synchronize(device)
    finally:
        torch.set_float32_matmul_precision(prev)
    seconds = start.elapsed_time(end) / 1e3
    roof = 2.0 * dim ** 3 * 4 * timed_calls / seconds
    here, data = card_fields(device), {}
    if os.path.exists(MATMUL_ROOF_PATH):
        with open(MATMUL_ROOF_PATH) as f:
            data = json.load(f)
    if data.get("device") != here:
        data = {}
    data.update({f"{name}_flops_per_s": roof, f"{name}_dim": dim,
                 "device": here})
    os.makedirs(os.path.dirname(MATMUL_ROOF_PATH), exist_ok=True)
    with open(MATMUL_ROOF_PATH, "w") as f:
        json.dump(data, f, indent=1)
    return roof


def matmul_flops(fn: Callable, *args, **kwargs) -> int:
    """2 M N K summed over every matrix product ``fn(*args, **kwargs)``
    runs (batched products count each batch), by ``FlopCounterMode``:
    what XLA's dot counts, with every trip of a loop counted.  A call
    under autograd counts its backward's products too; convolutions are
    not products and are left out."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    counts = counter.get_flop_counts().get("Global", {})
    return int(sum(n for op, n in counts.items()
                   if "convolution" not in str(op)))

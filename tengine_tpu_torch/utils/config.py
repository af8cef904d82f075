"""Runtime options — the typed-config equivalent of the reference's 3-tier
flag system (CMake options / options_t / TG_DEBUG_* env vars; SURVEY §5).

PyTorch port of tengine_tpu/utils/config.py: the same fields and the same
TT_* environment variables, so one Options value means the same thing to
both engines. Fields that select a kernel or pass the port does not have
yet make compile_graph raise NotImplementedError naming it
(executor/engine.py). Three fields are accepted and ignored until the port
has their host layer: profile and dump_dir (ROADMAP queue 1, item 12) and
donate_input (item 3, the compiled forward).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional


def _env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("", "0", "false", "False")


@dataclass(frozen=True)
class Options:
    """Per-run execution options.

    precision: "fp32" | "fp32_fast" | "bf16" | "fp16" — compute dtype for
        float graphs (the port runs "fp32" in full float32, TF32 off).
    quant_mode: "auto"  — quantized tmfile runs quantized, float runs float;
                "ref"   — quantized graphs use the bit-faithful
                          dequant→fp32→requant reference semantics
                          (conv_kernel_ref_uint8.c:67-177 analog, the
                          TG_DEBUG_REF oracle);
                "fast"  — quantized graphs use exact integer convolutions
                          with fused requantization;
                "float" — ignore quant params, run everything fp32.
    force_ref_kernels: pick the lowest-score kernel for every op
        (TG_DEBUG_REF analog, cpu_module.c:157-166).
    profile: record per-op timing (TG_DEBUG_TIME analog, cpu_device.c:79-156);
        accepted and ignored by the port for now.
    dump_dir: dump every node's output tensors (TG_DEBUG_DATA analog);
        accepted and ignored by the port for now.
    donate_input: allow the engine to reuse input buffers; accepted and
        ignored by the port for now.
    """

    precision: str = "fp32"
    quant_mode: str = "auto"
    force_ref_kernels: bool = False
    profile: bool = False
    dump_dir: Optional[str] = None
    donate_input: bool = False
    batch_size: Optional[int] = None  # override model batch dim
    # numeric sanitizer (TE_ENABLE_MEMORY_CHECK analog). Env: TT_DEBUG_NANS.
    debug_nans: bool = False
    internal_layout: str = "NHWC"  # lowering layout for conv stacks: NHWC | NCHW
    # Physical layout of 4-D graph inputs at the engine boundary. The IR is
    # NCHW (tmfile semantics) and that stays the default API contract; with
    # "NHWC" the caller hands NHWC arrays. Outputs are semantic NCHW.
    input_layout: str = "NCHW"
    # Rewrite small-channel stride-2 stem convs as SpaceToDepth + stride-1
    # conv at compile time (passes.stem_conv_s2d; not ported yet).
    stem_s2d: bool = False
    # Route large pointwise convs / FC to the qgemm_requant kernel (with
    # quant_bf16_storage=False; ops/cuda/qgemm.py).
    pallas_qgemm: bool = False
    # The JAX engine stores quantized activations as bf16 when True. The
    # port always stores the integer dtype (both hold identical values);
    # the field still decides which kernels the JAX rules would route to.
    quant_bf16_storage: bool = True
    # Direct k×k int8 conv kernels qconv_direct / qconv1x1 when
    # quant_bf16_storage=False (ops/cuda/qconv.py).
    pallas_qconv: bool = True
    # Fused stem kernel (ops/cuda/stem_conv.py) for the first-layer
    # small-channel stride-2 quantized conv.
    pallas_stem: bool = True
    # Relaxed-numerics quantized tier: a fused residual add is rounded once
    # at the block-output scale (single rounding). quant_mode="ref" and
    # quant_relaxed=False give the exact engines.
    quant_relaxed: bool = True
    # Native-int8 storage/compute plan ("auto" | "on" | "off"): every
    # activation stored as its 1-byte dtype, UINT8 graphs shifted to INT8
    # (graph/passes.py:to_native_int8). "auto" takes it with quant_relaxed
    # where executor/engine.py:_native_profitable says so.
    quant_native: str = "auto"
    # Minimum bottleneck width (c_mid) from which quant_relaxed alone fuses
    # int8 bottleneck chains into FusedResBlockChain nodes
    # (graph/passes.py:fuse_resnet_blocks); narrower blocks stay on the
    # per-conv lowerings. The default is the JAX package's.
    chain_min_cmid: int = 256
    # Fuse every int8 bottleneck residual chain, at any width, into
    # FusedResBlockChain nodes run by the qblock_chain kernel
    # (ops/fused.py, ops/cuda/qblock.py): the exact epilogue with
    # quant_relaxed=False, one rounding per block with quant_relaxed=True.
    fuse_resblock: bool = False

    @classmethod
    def from_env(cls, **overrides) -> "Options":
        """Env-var tier, mirroring TG_DEBUG_* (cpu_define.h:40-44)."""
        base = cls(
            force_ref_kernels=_env_flag("TT_DEBUG_REF"),
            profile=_env_flag("TT_DEBUG_TIME"),
            dump_dir=os.environ.get("TT_DEBUG_DATA_DIR")
            or ("tt_dump" if _env_flag("TT_DEBUG_DATA") else None),
            debug_nans=_env_flag("TT_DEBUG_NANS"),
        )
        return replace(base, **overrides)

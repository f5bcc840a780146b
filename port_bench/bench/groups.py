"""Device operations grouped by kernel name.

A frozen copy of ``GROUPS`` in ``tools/profile_torch_train_step.py`` (commit
ef50548): the first group whose keys one appears in the kernel's name takes it,
and a name that none matches is ``other``.  One key is added: the fused AdamW's
kernel is ``multi_tensor_apply_kernel<..., FusedAdamMathFunctor<...>>``, which
the copied key ``adam`` (lower case) does not match.
"""

from __future__ import annotations

K1_BWD, K1_FWD = "K1 bwd (windowed_nmf_bwd.cu)", "K1 fwd (windowed_nmf.cu)"
K2_BWD, K2_FWD = "K2 bwd (mlp_block_bwd.cu)", "K2 fwd (mlp_block.cu)"
K3_DW_SUM, K3_DW, K3_FWD = ("K3 dw, summing pass (depthwise_conv_dw.cu)", "K3 dw (depthwise_conv_dw.cu)",
                            "K3 fwd and dx (depthwise_conv.cu)")
LAYER_NORM, INSTANCE_NORM = "LayerNorm fwd+bwd", "InstanceNorm statistics (var_mean)"
OPTIMISER = "optimiser (fused AdamW)"

GROUPS = (  # first match wins
    (K1_BWD, ("windowed_nmf_shift_bwd",)),
    # windowed_nmf_shift: K1 fwd's kernel where it launched once per shift, so that an older tree classifies alike
    (K1_FWD, ("windowed_nmf_factors", "windowed_nmf_reconstruct", "windowed_nmf_shift")),
    ("K4 bwd (nmf_bwd.cu)", ("nmf_reconstruct_bwd",)),
    ("K4 fwd (nmf.cu)", ("nmf_reconstruct",)),
    (K2_BWD, ("prenorm_mlp_bwd", "sum_partials")),
    (K2_FWD, ("prenorm_mlp", "sum_shares", "to_bf16")),
    (K3_DW_SUM, ("sum_dw_partials",)),
    (K3_DW, ("depthwise_conv_dw",)),
    (K3_FWD, ("depthwise_conv",)),
    (LAYER_NORM, ("layer_norm", "LayerNorm", "GammaBeta")),
    (INSTANCE_NORM, ("WelfordOps", "welford", "var_mean")),
    ("GEMMs (cuBLAS)", ("cublas", "gemv", "splitK", "cutlass")),
    ("cuDNN convolutions and their layout transposes", ("cudnn", "conv", "nchwToNhwc", "nhwcToNchw", "xmma", "wgrad", "dgrad")),
    (OPTIMISER, ("adam", "FusedAdam")),
    ("roll (the flat route's shifts)", ("roll_cuda",)),
    ("concat / copies (the flat route's folds and unfolds among them)", ("CatArray", "copy", "Memcpy", "Memset")),
    ("reductions (loss, norms, bias grads)", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
)

NORMS = (LAYER_NORM, INSTANCE_NORM)


def group_of(name: str) -> str:
    return next((g for g, keys in GROUPS if any(k in name for k in keys)), "other")


def by_group(by_kernel: dict) -> dict:
    """kernel name -> seconds, summed into group -> seconds."""
    out: dict = {}
    for name, seconds in by_kernel.items():
        g = group_of(name)
        out[g] = out.get(g, 0.0) + seconds
    return out

"""Distributed FFT dataflow graph (paper §VI.C.4 — 1T-point FFT).

Pencil/volumetric decomposition [44]: three local FFT stages separated by two
global transposes (all-to-all). Communication-intensive — the paper's FFT
heatmaps (Fig 16/17) show NVLink/dragonfly dominating, mirroring DLRM.
"""
from __future__ import annotations

import math

from ..core.graph import DataflowGraph, Kernel, KernelKind, Tensor
from ..core.interchip import TrainWorkload

BYTES = 8  # complex64


def fft_graph(n_points: float = 1e12) -> DataflowGraph:
    n1 = round(n_points ** (1 / 3))
    flops_stage = 5.0 * n_points * math.log2(max(n1, 2))  # 5N log2(n) per dim
    vol = n_points * BYTES
    ks = [
        Kernel("FFT_x", flops_stage, KernelKind.FFT, gemm_dims=(n1, n1, n1)),
        Kernel("Transpose1", 0.0, KernelKind.COMM),
        Kernel("FFT_y", flops_stage, KernelKind.FFT, gemm_dims=(n1, n1, n1)),
        Kernel("Transpose2", 0.0, KernelKind.COMM),
        Kernel("FFT_z", flops_stage, KernelKind.FFT, gemm_dims=(n1, n1, n1)),
    ]
    ts = [
        Tensor("v1", "FFT_x", "Transpose1", vol),
        Tensor("v2", "Transpose1", "FFT_y", vol),
        Tensor("v3", "FFT_y", "Transpose2", vol),
        Tensor("v4", "Transpose2", "FFT_z", vol),
    ]
    return DataflowGraph(ks, ts, f"fft_{n_points:.0e}")


def fft_workload(n_points: float = 1e12) -> TrainWorkload:
    return TrainWorkload(name="fft_1t", layer_graph=fft_graph(n_points),
                         n_layers=1, global_batch=1, microbatch=1,
                         bwd_flop_mult=0.0,
                         optimizer_bytes_per_param_byte=0.0)

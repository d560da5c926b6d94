"""The port's side of ``tests/test_torch_dp.py`` (job ``dp``, the explicit
engine), ``tests/test_torch_gspmd_mesh.py`` (jobs ``gspmd`` and ``plan``,
the GSPMD engine), ``tests/test_torch_dp_moe.py`` (job ``dp_moe``: the
layered epoch with MoE expert rows and q8/q4 rows, and the GSPMD engine on
the MoE family), ``tests/test_torch_tp.py`` / ``tests/test_torch_tp_serve.py``
(jobs ``tp`` and ``tp_serve``: the model axis), ``tests/test_torch_cp_serve.py``
(job ``cp_serve``: serving under context parallelism) and
``tests/test_torch_moe_tp.py`` (job ``moe_tp``: MoE on the model axis,
trained and served), ``tests/test_torch_recurrent_tp.py`` (job
``recurrent_tp``: the SSM and the hybrid on the model axis, trained and
served) and ``tests/test_torch_encdec_tp.py`` (job ``encdec_tp``: the
encoder-decoder on the model axis, trained and served): one process per
rank over
``torch.distributed`` (gloo on the CPU), spawned by ``spawn`` and run as a
script. Imports torch, numpy and ``repro_torch`` only, never JAX (pytest
does not collect this file).

A rank joins the group through a file store in the spawn's scratch
directory (no TCP port, so parallel test workers cannot collide), runs one
thread, runs its ``JOBS`` entry and saves its results to
``<scratch>/<job>_w<world>.rank<r>.pt``, then leaves the group. ``spawn`` starts the
ranks, joins them under a hard timeout that kills them all, and raises if
any failed.

  python tests/torch_dp_worker.py <job> <rank> <world> <scratch dir>
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

STEPS = 3
B, S = 4, 16  # the global batch: every dp here divides it
LR, WARMUP = 3e-3, 2

# case -> (dp, d_model (None: the smoke width), param, grad, opt tiers,
# grad_compression, partition_mode). The smoke smollm's row at 2 layers has
# P = 24,672 elements, a multiple of 4, so the dp-4 case takes d_model 47:
# P = 24,158 pads to 24,160 (two zeros in rank 3's slice).
CASES = {
    "allgather_dp2": (2, None, "device", "device", "device", "none", "allgather"),
    "allgather_dp4": (4, 47, "device", "device", "device", "none", "allgather"),
    "broadcast_dp2": (2, None, "device", "device", "device", "none", "broadcast"),
    "int8_dp2": (2, None, "device", "device", "device", "int8", "allgather"),
    "offgraph_dp2": (2, None, "device", "nvme", "nvme", "none", "allgather"),
    "layered_dp2": (2, None, "nvme", "nvme", "nvme", "none", "allgather"),
}
# the GSPMD engine's cases: case -> (dp, arch, d_model (None: the smoke
# width), zero stage, param, grad, opt tiers, grad_accum, global batch B).
# smollm is cut to 2 layers, the other families keep their smoke depth; S
# is 16 tokens (seamless: 64 frames, 16 decoder tokens). d_model 47 splits
# over no rank: every leaf stays whole (the divisibility guard), and B = 3
# does not split over 2 ranks: both take the whole batch.
GSPMD_CASES = {
    "stage3_dp2": (2, "smollm-135m", None, 3, "device", "device", "device", 1, 4),
    "stage3_dp4": (4, "smollm-135m", None, 3, "device", "device", "device", 1, 4),
    "stage0_dp2": (2, "smollm-135m", None, 0, "device", "device", "device", 1, 4),
    "stage1_dp2": (2, "smollm-135m", None, 1, "device", "device", "device", 1, 4),
    "stage2_dp2": (2, "smollm-135m", None, 2, "device", "device", "device", 1, 4),
    "host_dp2": (2, "smollm-135m", None, 3, "host", "device", "host", 1, 4),
    "nvme_opt_dp2": (2, "smollm-135m", None, 3, "device", "nvme", "nvme", 1, 4),
    "accum2_dp2": (2, "smollm-135m", None, 3, "device", "device", "device", 2, 4),
    "unsplit_dp2": (2, "smollm-135m", 47, 3, "device", "device", "device", 1, 4),
    "batch3_dp2": (2, "smollm-135m", None, 3, "device", "device", "device", 1, 3),
    "vlm_dp2": (2, "llava-next-34b", None, 3, "device", "device", "device", 1, 4),
    "hybrid_dp2": (2, "recurrentgemma-9b", None, 3, "device", "device", "device", 1, 4),
    "ssm_dp2": (2, "mamba2-370m", None, 3, "device", "device", "device", 1, 4),
    "encdec_dp2": (2, "seamless-m4t-medium", None, 3, "device", "device", "device", 1, 4),
}
GSPMD_STEPS = 2
# the GSPMD engine's MoE cases (job dp_moe), in GSPMD_CASES' format: the
# smoke granite at ZeRO-3 (its expert leaves at moe_zero_stage 3), one
# microbatch and two; each at one device too (the test's one-rank
# baselines: the "_dp1" cases run in the test process, never spawned)
MOE_GSPMD_CASES = {
    f"moe_{name}_dp{dp}": (dp, "granite-moe-1b-a400m", None, 3, "device", "device", "device",
                           accum, 4)
    for name, accum in (("stage3", 1), ("accum2", 2)) for dp in (2, 1)}
# the model axis' cases (job tp, tests/test_torch_tp.py): case -> (data,
# model, arch, zero stage, param, grad, opt tiers, grad_accum, attention
# strategy); the global batch is 4 x 16 (llava: 8 vision positions and 8
# tokens), smollm cut to 2 layers. llama's 4 heads and 2 KV heads split over
# 2 model ranks, over 4 the KV heads stay whole (each rank its query head's
# one), as nemotron's 2 over 4 and llava's over 4; smollm's 3 heads split
# over neither 2 nor 4: context parallelism, as llava's under "cp"
TP_CASES = {
    "llama_tp_1x2": (1, 2, "llama3.2-3b", 3, "device", "device", "device", 1, "auto"),
    "llama_tp_1x4": (1, 4, "llama3.2-3b", 3, "device", "device", "device", 1, "auto"),
    "llama_tp_2x2": (2, 2, "llama3.2-3b", 3, "device", "device", "device", 1, "auto"),
    "smollm_cp_1x2": (1, 2, "smollm-135m", 3, "device", "device", "device", 1, "auto"),
    "smollm_cp_2x2": (2, 2, "smollm-135m", 3, "device", "device", "device", 1, "auto"),
    "vlm_tp_1x4": (1, 4, "llava-next-34b", 3, "device", "device", "device", 1, "auto"),
    "vlm_cp_1x2": (1, 2, "llava-next-34b", 3, "device", "device", "device", 1, "cp"),
    "gemma_tp_1x2": (1, 2, "gemma-7b", 3, "device", "device", "device", 1, "auto"),
    "nemotron_tp_1x4": (1, 4, "nemotron-4-340b", 3, "device", "device", "device", 1, "auto"),
    "stage0_tp_2x2": (2, 2, "llama3.2-3b", 0, "device", "device", "device", 1, "auto"),
    "stage1_tp_2x2": (2, 2, "llama3.2-3b", 1, "device", "device", "device", 1, "auto"),
    "stage2_cp_2x2": (2, 2, "smollm-135m", 2, "device", "device", "device", 1, "auto"),
    "host_cp_2x2": (2, 2, "smollm-135m", 3, "host", "device", "host", 1, "auto"),
    "nvme_opt_tp_2x2": (2, 2, "llama3.2-3b", 3, "device", "nvme", "nvme", 1, "auto"),
    "accum2_tp_2x2": (2, 2, "llama3.2-3b", 3, "device", "device", "device", 2, "auto"),
}
# MoE on the model axis (job moe_tp, tests/test_torch_moe_tp.py), in
# TP_CASES' format: the smoke granite (4 heads, 2 KV heads, 8 experts)
# under tensor parallelism at (1, 2) and (2, 2) (2 KV heads and 4 experts a
# rank) and (1, 4) (the KV heads whole, 2 experts a rank), and under
# context parallelism at (1, 3) (4 heads over 3; 8 experts, 32 columns and
# the vocab split over none: every leaf whole) on 4 x 18 tokens; the
# "_dp1" cases are their one-device baselines, on the same global batches
MOE_TP_CASES = {
    "moe_tp_1x2": (1, 2, "granite-moe-1b-a400m", 3, "device", "device", "device", 1, "auto"),
    "moe_tp_2x2": (2, 2, "granite-moe-1b-a400m", 3, "device", "device", "device", 1, "auto"),
    "moe_tp_1x4": (1, 4, "granite-moe-1b-a400m", 3, "device", "device", "device", 1, "auto"),
    "moe_cp_1x3": (1, 3, "granite-moe-1b-a400m", 3, "device", "device", "device", 1, "auto"),
    "moe_tp_dp1": (1, 1, "granite-moe-1b-a400m", 3, "device", "device", "device", 1, "auto"),
    "moe_cp_dp1": (1, 1, "granite-moe-1b-a400m", 3, "device", "device", "device", 1, "auto"),
}
MOE_TP_SEQ = {"moe_cp_1x3": 18, "moe_cp_dp1": 18}
# the SSM's and the hybrid's inner channels on the model axis (job
# recurrent_tp, tests/test_torch_recurrent_tp.py), in TP_CASES' format: the
# smoke mamba2 (no attention heads: context parallelism under "auto"; d_in
# 128 and 8 SSD heads split over 2 and 4) at (1, 2), (2, 2) and (1, 4), and
# under tensor parallelism forced at (1, 2); the smoke recurrentgemma (4
# heads, 1 KV head, lru_width 64) under tensor parallelism at (1, 2) and
# (2, 2), under context parallelism at (1, 3) on 18 tokens (4 heads over
# 3; lru_width, the vocab and the MLP's 192 columns: the inner channels
# whole, the rank runs the whole block and keeps its chunk) and forced at
# (1, 2) with a window of 4, shorter than its 8-token chunk; "ssm_dp1" is
# the reference's one-device run of the mamba2 cases (its rounding spread
# across layouts: mamba2's second step is rounding-sensitive)
RECURRENT_TP_CASES = {
    "ssm_cp_1x2": (1, 2, "mamba2-370m", 3, "device", "device", "device", 1, "auto"),
    "ssm_cp_2x2": (2, 2, "mamba2-370m", 3, "device", "device", "device", 1, "auto"),
    "ssm_cp_1x4": (1, 4, "mamba2-370m", 3, "device", "device", "device", 1, "auto"),
    "ssm_tp_1x2": (1, 2, "mamba2-370m", 3, "device", "device", "device", 1, "tp"),
    "hybrid_tp_1x2": (1, 2, "recurrentgemma-9b", 3, "device", "device", "device", 1, "auto"),
    "hybrid_tp_2x2": (2, 2, "recurrentgemma-9b", 3, "device", "device", "device", 1, "auto"),
    "hybrid_cp_1x3": (1, 3, "recurrentgemma-9b", 3, "device", "device", "device", 1, "auto"),
    "hybrid_cp_1x2": (1, 2, "recurrentgemma-9b", 3, "device", "device", "device", 1, "cp"),
    "ssm_dp1": (1, 1, "mamba2-370m", 3, "device", "device", "device", 1, "auto"),
}
RECURRENT_TP_SEQ = {"hybrid_cp_1x3": 18}
GSPMD_CUT = {"hybrid_cp_1x2": {"window": 4}}  # a case's config fields beyond the smoke's
# the encoder-decoder on the model axis (job encdec_tp, tests/test_torch_
# encdec_tp.py), in TP_CASES' format: the smoke seamless (4 heads, 4 KV
# heads, 64 frames and 16 decoder tokens a row) under tensor parallelism
# at (1, 2), (1, 4) (one head a rank) and (2, 2) (ZeRO-3: 2-D shards),
# under context parallelism forced at (1, 2) and under "auto" at (1, 3),
# where 4 heads do not split over 3, on 72 frames and 18 decoder tokens
ENCDEC_TP_CASES = {
    "encdec_tp_1x2": (1, 2, "seamless-m4t-medium", 3, "device", "device", "device", 1, "auto"),
    "encdec_tp_1x4": (1, 4, "seamless-m4t-medium", 3, "device", "device", "device", 1, "auto"),
    "encdec_tp_2x2": (2, 2, "seamless-m4t-medium", 3, "device", "device", "device", 1, "auto"),
    "encdec_cp_1x2": (1, 2, "seamless-m4t-medium", 3, "device", "device", "device", 1, "cp"),
    "encdec_cp_1x3": (1, 3, "seamless-m4t-medium", 3, "device", "device", "device", 1, "auto"),
}
ENCDEC_TP_SEQ = {"encdec_cp_1x3": 72}
# params on NVMe through the GSPMD leaf scheduler on a mesh (job nvme_mesh,
# tests/test_torch_nvme_mesh.py), in TP_CASES' format: the smoke smollm (2
# layers) at (2, 1) under ZeRO-3 with the in-graph update (fused Adam through
# its plain version) and with every state class on NVMe (the masters
# rounded on the host), at stage 1 all on NVMe (params whole, the masters
# split: each rank writes back the gathered whole leaf), the smoke llama
# under tensor parallelism at (2, 2), smollm under context parallelism at
# (1, 2), and q8 / q4 at (2, 1) (``GSPMD_QUANT``: each rank's shards encoded
# on their own grids)
NVME_MESH_CASES = {
    "nvme_stage3_2x1": (2, 1, "smollm-135m", 3, "nvme", "device", "device", 1, "auto"),
    "all_nvme_stage3_2x1": (2, 1, "smollm-135m", 3, "nvme", "nvme", "nvme", 1, "auto"),
    "all_nvme_stage1_2x1": (2, 1, "smollm-135m", 1, "nvme", "nvme", "nvme", 1, "auto"),
    "nvme_tp_2x2": (2, 2, "llama3.2-3b", 3, "nvme", "nvme", "nvme", 1, "auto"),
    "nvme_cp_1x2": (1, 2, "smollm-135m", 3, "nvme", "device", "device", 1, "auto"),
    "q8_2x1": (2, 1, "smollm-135m", 3, "nvme", "device", "device", 1, "auto"),
    "q4_2x1": (2, 1, "smollm-135m", 3, "nvme", "device", "device", 1, "auto"),
}
GSPMD_QUANT = {"q8_2x1": "q8", "q4_2x1": "q4"}
MODEL_AXIS_CASES = {**TP_CASES, **MOE_TP_CASES, **RECURRENT_TP_CASES, **ENCDEC_TP_CASES,
                    **NVME_MESH_CASES}
ALL_GSPMD_CASES = {**GSPMD_CASES, **MOE_GSPMD_CASES,
                   **{case: (D * M, arch, None, stage, param, grad, opt, accum, 4)
                      for case, (D, M, arch, stage, param, grad, opt, accum, _)
                      in MODEL_AXIS_CASES.items()}}


def gspmd_mesh(case: str) -> tuple:
    """``case``'s mesh and attention strategy: (data, model, strategy)."""
    if case in MODEL_AXIS_CASES:
        D, M, *_, strategy = MODEL_AXIS_CASES[case]
        return D, M, strategy
    return ALL_GSPMD_CASES[case][0], 1, "auto"
# the layered epoch's cases of job dp_moe, every state class on NVMe: case
# -> (dp, arch, d_model (None: the smoke width), param_quant). smollm is cut
# to 2 layers, granite keeps its smoke depth (2). The smoke smollm's row,
# P = 24,672, splits into slices of 12,336 at dp 2, 16 elements off the
# 32-element quant grid: the second slice's blocks start mid-leaf. The
# aligned case takes d_model 64 (P = 32,896, slices of 16,448 = 514
# blocks, so the two grids join into the row's own: test_torch_training's
# QUANT_D, its MLP leaves' N multiples of 32, w_gate across the boundary);
# the dp-4 case d_model 47 (P = 24,158 pads to 24,160, slices of 6040, 24
# off the grid).
LAYERED_CASES = {
    "moe_layered_dp2": (2, "granite-moe-1b-a400m", None, "none"),
    "moe_layered_dp4": (4, "granite-moe-1b-a400m", None, "none"),
    "q8_layered_dp2": (2, "smollm-135m", None, "q8"),
    "q8_layered_dp2_aligned": (2, "smollm-135m", 64, "q8"),
    "q8_layered_dp4": (4, "smollm-135m", 47, "q8"),
    "q4_layered_dp2": (2, "smollm-135m", None, "q4"),
    "moe_q8_layered_dp2": (2, "granite-moe-1b-a400m", None, "q8"),
    # the MoE cases' one-rank baselines, on the same global batches
    "moe_layered_dp1": (1, "granite-moe-1b-a400m", None, "none"),
    "moe_q8_layered_dp1": (1, "granite-moe-1b-a400m", None, "q8"),
}
# the plan job's argv: the planner's hardware pinned (no detected number
# enters the plan), two devices, the smoke smollm
PLAN_ARGV = ["--smoke", "--device", "cpu", "--plan", "auto", "--hw-devices", "2",
             "--hw-device-mem", "4e9", "--hw-host-mem", "64e9", "--hw-nvme", "1e12",
             "--steps", "3", "--batch", "4", "--seq", "16", "--lr", "3e-3",
             "--ckpt-every", "0", "--log-every", "100"]
# the encoder-decoder's plan on the model axis (job encdec_tp): the same
# hardware, the smoke seamless at 64 frames, both devices on the model axis
ENCDEC_PLAN_ARGV = ["--smoke", "--device", "cpu", "--plan", "auto", "--hw-devices", "2",
                    "--hw-device-mem", "4e9", "--hw-host-mem", "64e9", "--hw-nvme", "1e12",
                    "--steps", "3", "--batch", "4", "--seq", "64", "--lr", "3e-3",
                    "--ckpt-every", "0", "--log-every", "100", "--arch", "seamless-m4t-medium",
                    "--model-mesh", "2"]
# the serving cases (job serve): case -> (dp, arch, layers (0: the smoke
# depth), flags). Five sequences through two slots, four new tokens each,
# the prompts of tests/test_torch_kv_counters.py; at dp 4 the two slots do
# not divide over the ranks (the batch replicated). The plan's case pins
# its hardware (no detected number enters the plan) and keeps the two
# slots as an override.
SERVE_ARGV = ["--smoke", "--batch", "5", "--kv-slots", "2", "--new-tokens", "4"]
SERVE_PROMPT = {"llava-next-34b": 16, "seamless-m4t-medium": 16}
_HOST = ["--kv-tier", "host"]
SERVE_CASES = {
    "smollm_dp2": (2, "smollm-135m", 0, _HOST),
    "smollm_dp4": (4, "smollm-135m", 0, _HOST),
    "moe_dp2": (2, "granite-moe-1b-a400m", 0, _HOST),
    "ssm_dp2": (2, "mamba2-370m", 0, _HOST),
    "hybrid_dp2": (2, "recurrentgemma-9b", 5, _HOST),
    "vlm_dp2": (2, "llava-next-34b", 0, _HOST),
    "encdec_dp2": (2, "seamless-m4t-medium", 0, _HOST),
    "q8_dp2": (2, "smollm-135m", 0, _HOST + ["--kv-quant", "q8"]),
    "nvme_dp2": (2, "smollm-135m", 0, ["--kv-tier", "nvme"]),
    "plan_dp2": (2, "smollm-135m", 0, ["--plan", "auto", "--hw-devices", "2",
                                       "--hw-device-mem", "4e9", "--hw-host-mem", "64e9",
                                       "--hw-nvme", "1e12"]),
}
# the model axis' serving cases (job tp_serve, tests/test_torch_tp_serve.py),
# in SERVE_CASES' format with the mesh in the flags: case -> (ranks, arch,
# layers, flags). llama's and llava's KV heads split over 2 model ranks,
# llava's 2 over 4 do not (each rank parks its query head's one)
_TP2, _TP4 = ["--model-mesh", "2", "--data-mesh", "1"], ["--model-mesh", "4", "--data-mesh", "1"]
TP_SERVE_CASES = {
    "llama_tp_1x2": (2, "llama3.2-3b", 0, _HOST + _TP2),
    "llama_tp_2x2": (4, "llama3.2-3b", 0, _HOST + ["--model-mesh", "2", "--data-mesh", "2"]),
    "vlm_tp_1x2": (2, "llava-next-34b", 0, _HOST + _TP2),
    "vlm_tp_1x4": (4, "llava-next-34b", 0, _HOST + _TP4),
    "q8_tp_1x2": (2, "llama3.2-3b", 0, _HOST + ["--kv-quant", "q8"] + _TP2),
    "nvme_tp_1x2": (2, "llama3.2-3b", 0, ["--kv-tier", "nvme"] + _TP2),
}
# context parallelism's serving cases (job cp_serve, tests/test_torch_cp_serve.py;
# smollm's 3 heads over 2 model ranks, llava's 4 over 3): the capacity
# prompt + new tokens splits over the model ranks (smollm 8 + 4: 6
# positions a rank, the prompt chunked; llava 18 + 3 over 3: 7 a rank,
# its 8 vision positions in the first two chunks), on the NVMe tier with
# a 4-token prompt (5 a rank: rank 1 parks nothing, the decode crosses
# from rank 0's range to rank 1's) and at 8 + 5 (13 positions do not
# split: the whole cache on each rank); MoE on the model axis (job
# moe_tp): granite under tensor parallelism at (1, 2) and context
# parallelism at (1, 3) (9 + 3: 4 positions a rank, the prompt chunked)
_CP3 = ["--model-mesh", "3", "--data-mesh", "1"]
CP_SERVE_CASES = {
    "smollm_cp_1x2": (2, "smollm-135m", 0, _HOST + _TP2),
    "smollm_cp_2x2": (4, "smollm-135m", 0, _HOST + ["--model-mesh", "2", "--data-mesh", "2"]),
    "vlm_cp_1x3": (3, "llava-next-34b", 0, _HOST + _CP3 + ["--prompt-len", "18",
                                                           "--new-tokens", "3"]),
    "nvme_cp_1x2": (2, "smollm-135m", 0, ["--kv-tier", "nvme", "--prompt-len", "4",
                                          "--new-tokens", "6"] + _TP2),
    "whole_cp_1x2": (2, "smollm-135m", 0, _HOST + ["--new-tokens", "5"] + _TP2),
}
MOE_SERVE_CASES = {
    "moe_tp_serve_1x2": (2, "granite-moe-1b-a400m", 0, _HOST + _TP2),
    "moe_cp_serve_1x3": (3, "granite-moe-1b-a400m", 0, _HOST + _CP3 + ["--prompt-len", "9",
                                                                       "--new-tokens", "3"]),
}
# the recurrent families served on the model axis (job recurrent_tp): each
# at (1, 2) under its "auto" strategy (mamba2 context parallelism, the
# prompt chunked; recurrentgemma at 5 layers, one group and the two-block
# tail, tensor parallelism) and under the other forced (``SERVE_STRATEGY``:
# each side's serve run forces it in its run's config); the forced
# hybrid's 40-token prompt, chunked, passes its window of 32: the rings
# are laid out from the gathered K/V, rolled
RECURRENT_SERVE_CASES = {
    "ssm_cp_serve_1x2": (2, "mamba2-370m", 0, _HOST + _TP2),
    "ssm_tp_serve_1x2": (2, "mamba2-370m", 0, _HOST + _TP2),
    "hybrid_tp_serve_1x2": (2, "recurrentgemma-9b", 5, _HOST + _TP2),
    "hybrid_cp_serve_1x2": (2, "recurrentgemma-9b", 5, _HOST + _TP2 + ["--prompt-len", "40"]),
}
# the encoder-decoder served on the model axis (job encdec_tp) at (1, 2):
# 16 frames and 4 decoder tokens a prompt, 4 new tokens (a capacity of 8),
# under tensor parallelism ("auto") and context parallelism forced (the
# frames and tokens chunked, the decode cache and the memory's xk / xv
# split over the ranks), and forced again at 5 new tokens (9 positions do
# not split: every rank holds the whole cache, xk / xv gathered)
ENCDEC_SERVE_CASES = {
    "encdec_tp_serve_1x2": (2, "seamless-m4t-medium", 0, _HOST + _TP2),
    "encdec_cp_serve_1x2": (2, "seamless-m4t-medium", 0, _HOST + _TP2),
    "encdec_cp_whole_serve_1x2": (2, "seamless-m4t-medium", 0,
                                  _HOST + _TP2 + ["--new-tokens", "5"]),
}
# the serving cases whose attention strategy is forced, not "auto"
SERVE_STRATEGY = {"ssm_tp_serve_1x2": "tp", "hybrid_cp_serve_1x2": "cp",
                  "encdec_cp_serve_1x2": "cp", "encdec_cp_whole_serve_1x2": "cp"}
# every serving case on a model axis
MODEL_SERVE_CASES = {**TP_SERVE_CASES, **CP_SERVE_CASES, **MOE_SERVE_CASES,
                     **RECURRENT_SERVE_CASES, **ENCDEC_SERVE_CASES}
ALL_SERVE_CASES = {**SERVE_CASES, **MODEL_SERVE_CASES}
# the teacher-forced decode tokens each model-axis serving case feeds
TEACHER_STEPS = 2
# the psum_compressed cases: (shape, dtype) over three steps of error feedback
PSUM_CASES = [((49, 7), "float32"), ((300,), "bfloat16"), ((2, 256), "float32")]


def psum_inputs(shape, step: int, world: int) -> np.ndarray:
    """The (world, *shape) f32 inputs of one psum_compressed step, each
    rank's its row (rounded to bf16 by the caller where the case is)."""
    rng = np.random.default_rng([len(shape), step, world])
    return (rng.standard_normal((world,) + tuple(shape))
            * np.array([1.0, 30.0, 1e-3, 7.0][:world]).reshape((world,) + (1,) * len(shape))
            ).astype(np.float32)


def host_metric(v):
    """A step metric as a host value: a 0-d tensor a float, a vector (MoE's
    (E,) ``moe_expert_load``) a list of floats."""
    import torch

    if isinstance(v, torch.Tensor):
        return float(v) if v.dim() == 0 else v.double().tolist()
    return v


def _name(job: str, world: int) -> str:
    return f"{job}_w{world}"


def spawn(job: str, world: int, tmp: str, timeout: float = 120.0) -> list:
    """Run ``job`` on ``world`` ranks, one process each, and return each
    rank's results in rank order; every rank is killed and the call raises
    if one fails or the spawn outlives ``timeout`` seconds."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    os.makedirs(tmp, exist_ok=True)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r),
                               str(world), tmp], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        outs = []
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise RuntimeError(f"{job}: {world} ranks outlived {timeout} s; killed")
    failed = [(r, out) for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    if failed:
        raise RuntimeError(f"{job}: rank {failed[0][0]} failed:\n{failed[0][1][-4000:]}")
    import torch

    return [torch.load(os.path.join(tmp, f"{_name(job, world)}.rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------


def _runs(case: str, nvme_dir: str):
    from repro_torch import configs
    from repro_torch.config import RunConfig, TrainConfig, make_offload, make_parallel

    dp, d_model, param, grad, opt, compress, mode = CASES[case]
    wide = {} if d_model is None else {"d_model": d_model}
    cfg = dataclasses.replace(configs.smoke("smollm-135m"), n_layers=2, **wide)
    return RunConfig(model=cfg,
                     parallel=make_parallel("zero3", remat="none", grad_compression=compress,
                                            partition_mode=mode),
                     offload=make_offload(param_tier=param, grad_tier=grad, opt_tier=opt,
                                          nvme_dir=nvme_dir),
                     train=TrainConfig(lr=LR, warmup_steps=WARMUP))


def init_path(tmp: str, case: str) -> str:
    """Where the test saves ``case``'s global initial state: the
    reference's tier-independent leaves (``flat`` padded for the case's
    dp, ``other``, ``other_opt``, ``step``) as the port's tensors."""
    dp, d_model = CASES[case][:2]
    return os.path.join(tmp, f"init_{d_model or 'smoke'}_dp{dp}.pt")


def run_case(case: str, tmp: str, mesh) -> dict:
    """``STEPS`` steps of ``case`` on this rank from the global initial
    state at ``init_path`` (its residual, in-graph master and moments
    completed on the rank as the reference's init draws them), on the
    rank's slices of the global batches."""
    import torch

    from repro_torch import bridge
    from repro_torch.config import ShapeConfig
    from repro_torch.core import executor as texec
    from repro_torch.data import pipeline as tpipe

    run = _runs(case, os.path.join(tmp, case, "torch"))
    ex = texec.InfinityExecutor(run, "cpu", mesh=mesh if mesh.world > 1 else None)
    init = torch.load(init_path(tmp, case), weights_only=False)
    state = bridge.shard_zero3_state(init, mesh.rank, mesh.world, run.parallel.partition_mode)
    state = ex.reseed(ex.engine.place_state(ex.engine.complete_state(state)))
    stream = tpipe.SyntheticStream(ex.input_specs(ShapeConfig("t", S, B, "train")),
                                   run.model.vocab_size, seed=0)
    step = ex.make_train_step()
    metrics = []
    for i in range(STEPS):
        batch = tpipe.rank_slice(stream.batch_at(i), mesh.rank, mesh.world)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append({k: (float(v) if isinstance(v, torch.Tensor) else v)
                        for k, v in m.items()})
    flat = ex.materialize_flat() if ex.layered else state["flat"]
    out = {"metrics": metrics, "flat": flat.float().clone(),
           "other": state["other"], "step": int(state["step"]),
           "opt_keys": sorted(ex.opt_store.keys()) if ex.opt_store is not None else []}
    for key in ("master", "m", "v", "g_err"):
        if key in state:
            out[key] = state[key]
    ex.close()
    return out


def job_dp(tmp: str, mesh) -> dict:
    """Every case at this world size, then, at 2 ranks, the units: the row
    gather against ``reduce_scatter_tensor`` and ``psum_compressed``."""
    out = {case: run_case(case, tmp, mesh) for case, spec in CASES.items()
           if spec[0] == mesh.world}
    if mesh.world == 2:
        out["row_gather"] = row_gather_unit(mesh)
        out["psum"] = psum_unit(mesh)
    return out


def row_gather_unit(mesh) -> dict:
    """``RowGather`` on this rank's bf16 slice: forward against
    ``all_gather_into_tensor``, the slice's gradient for a per-rank
    cotangent against ``reduce_scatter_tensor`` of that cotangent."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.zero import RowGather

    gen = torch.Generator().manual_seed(10 + mesh.rank)
    piece = torch.randn(96, generator=gen).to(torch.bfloat16).requires_grad_()
    ct = torch.randn(96 * mesh.world, generator=gen).to(torch.bfloat16)
    row = RowGather.apply(piece, mesh)
    (grad,) = torch.autograd.grad(row, piece, ct)
    want_row = torch.empty_like(row)
    dist.all_gather_into_tensor(want_row, piece.detach())
    want_grad = torch.empty_like(piece)
    dist.reduce_scatter_tensor(want_grad, ct)
    return {"row": row.detach(), "want_row": want_row, "grad": grad, "want_grad": want_grad}


def psum_unit(mesh) -> dict:
    """``psum_compressed`` over three steps of error feedback per case, on
    this rank's row of ``psum_inputs``: (reduced, new residual) per step."""
    import torch

    from repro_torch.optim import compression

    out = {}
    for shape, dtype in PSUM_CASES:
        err, steps = torch.zeros(shape), []
        for i in range(3):
            x = torch.from_numpy(psum_inputs(shape, i, mesh.world)[mesh.rank])
            x = x.to(getattr(torch, dtype))
            red, err = compression.psum_compressed(x, err, mesh)
            steps.append((red.float(), err))
        out[(shape, dtype)] = steps
    return out


# ---------------------------------------------------------------------------
# the GSPMD engine on the ranks
# ---------------------------------------------------------------------------


def gspmd_cfg(case: str, package):
    """``case``'s model config from ``package``'s ``configs`` (either
    package: their configs are equal field for field)."""
    _, arch, d_model, *_ = ALL_GSPMD_CASES[case]
    cfg = package.smoke(arch)
    cut = {"n_layers": 2} if arch == "smollm-135m" else {}
    if d_model is not None:
        cut["d_model"] = d_model
    return dataclasses.replace(cfg, **cut, **GSPMD_CUT.get(case, {}))


def gspmd_seq(case: str) -> int:
    seq = {**MOE_TP_SEQ, **RECURRENT_TP_SEQ, **ENCDEC_TP_SEQ}
    if case in seq:
        return seq[case]
    return 64 if ALL_GSPMD_CASES[case][1] == "seamless-m4t-medium" else S


def gspmd_init_path(tmp: str, case: str) -> str:
    """Where the test saves ``case``'s initial params: the reference
    engine's ``init_state`` at one device, as the port's whole tensors."""
    return os.path.join(tmp, f"gspmd_init_{case}.pt")


def _gspmd_run(case: str, nvme_dir: str):
    from repro_torch import configs
    from repro_torch.config import RunConfig, TrainConfig, make_offload, make_parallel

    _, _, _, stage, param, grad, opt, accum, _ = ALL_GSPMD_CASES[case]
    return RunConfig(model=gspmd_cfg(case, configs),
                     parallel=make_parallel("pjit", remat="none", zero_stage=stage,
                                            grad_accum=accum,
                                            attn_strategy=gspmd_mesh(case)[2]),
                     offload=make_offload(param_tier=param, grad_tier=grad, opt_tier=opt,
                                          nvme_dir=nvme_dir,
                                          param_quant=GSPMD_QUANT.get(case, "none")),
                     train=TrainConfig(lr=LR, warmup_steps=WARMUP))


def store_bytes(store) -> dict:
    """Every key of a store with the bytes it holds (a quantizing store's
    wire bytes)."""
    inner = getattr(store, "inner", store)
    store.flush()
    return {k: (lambda t: t.numel() * t.element_size())(inner.read(k).result())
            for k in store.keys()}


def run_gspmd_case(case: str, tmp: str, mesh) -> dict:
    """``GSPMD_STEPS`` steps of ``case`` on this rank from the global
    params at ``gspmd_init_path`` (Adam's masters their f32 copies, zero
    moments, as the reference's init), each rank its shards
    (``bridge.shard_gspmd_state``), on its rows of the global batches
    (``rank_batch``)."""
    import torch

    from repro_torch import bridge
    from repro_torch.config import ShapeConfig
    from repro_torch.core import executor as texec
    from repro_torch.data import pipeline as tpipe
    from repro_torch.optim import adam

    run = _gspmd_run(case, os.path.join(tmp, case, "torch"))
    ex = texec.InfinityExecutor(run, "cpu", mesh=mesh)
    params = torch.load(gspmd_init_path(tmp, case), weights_only=False)
    full = {"params": params}
    if not run.opt_offgraph:
        full["opt"] = adam.init_state(params)
    state = bridge.shard_gspmd_state(full, run, mesh.rank, mesh.data, mesh.model)
    state = ex.reseed(ex.engine.place_state(state))
    extra = {}
    if ex.param_nvme:  # the rank's shards as its store decodes them, before a step
        extra = {"init_decoded": ex.materialize_params(), "param_store": store_bytes(
            ex.param_store)}
    B = ALL_GSPMD_CASES[case][8]
    stream = tpipe.SyntheticStream(ex.input_specs(ShapeConfig("t", gspmd_seq(case), B, "train")),
                                   run.model.vocab_size, seed=0)
    step = ex.make_train_step()
    metrics = []
    for i in range(GSPMD_STEPS):
        batch = tpipe.rank_batch(stream.batch_at(i), mesh.coords()["data"], mesh.data,
                                 run.parallel.grad_accum)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append({k: host_metric(v) for k, v in m.items()})
    out = {"metrics": metrics, "splits": ex.engine.splits, **extra,
           "params": ex.materialize_params() if ex.param_nvme else state["params"],
           "model_splits": ex.engine.model_splits, "sizes": ex.engine.sizes,
           "strategy": ex.engine.mp.strategy if ex.engine.mp is not None else None,
           "shard_bytes": ex.engine.shard_bytes(),
           "opt_keys": sorted(ex.opt_store.keys()) if ex.opt_store is not None else []}
    if "opt" in state:
        out["opt"] = tuple(state["opt"])
    ex.close()
    return out


def job_gspmd(tmp: str, mesh) -> dict:
    """Every GSPMD case at this world size, then, at 2 ranks, the plan's
    run (``job_plan``)."""
    out = {case: run_gspmd_case(case, tmp, mesh) for case, spec in GSPMD_CASES.items()
           if spec[0] == mesh.world}
    if mesh.world == 2:
        out["plan"] = job_plan(tmp, mesh)
        out["leaf_gather"] = leaf_gather_unit(mesh)
    return out


def job_tp(tmp: str, mesh) -> dict:
    """Every model-axis case of this world size, each on a mesh of its
    own (``make_local_mesh(data, model)``: every rank creates the same
    groups in the same order), then, at 2 ranks, the model axis'
    autograd functions (``model_axis_unit``)."""
    from repro_torch.launch import mesh as mesh_mod

    out = {}
    for case, (D, M, *_) in TP_CASES.items():
        if D * M == mesh.world:
            out[case] = run_gspmd_case(case, tmp, mesh_mod.make_local_mesh(D, M, "cpu"))
    if mesh.world == 2:
        out["model_axis"] = model_axis_unit(mesh_mod.make_local_mesh(1, 2, "cpu"))
    return out


def model_axis_unit(mesh) -> dict:
    """``zero.ModelAxis`` on a (1, 2) mesh, bf16: ``enter`` the identity
    whose backward sums the ranks' cotangents, ``join`` the sum whose
    backward is the identity, ``gather`` along dim 1 whose backward is the
    reduce-scatter; each against the ranks' draws combined by hand."""
    import torch

    from repro_torch.core.zero import ModelAxis

    mp = ModelAxis(mesh, "tp")

    def draw(r):
        gen = torch.Generator().manual_seed(60 + r)
        return [torch.randn(*s, generator=gen).to(torch.bfloat16)
                for s in ((3, 4), (3, 4), (3, 4), (3, 4), (2, 5, 3), (2, 10, 3))]

    mine, all_ = draw(mesh.rank), [draw(r) for r in range(2)]
    x, ct_x, y, ct_y, s, ct_s = (t.clone().requires_grad_() if i in (0, 2, 4) else t
                                 for i, t in enumerate(mine))
    entered, joined, gathered = mp.enter(x), mp.join(y), mp.gather(s, 1)
    gx, gy, gs = torch.autograd.grad((entered, joined, gathered), (x, y, s), (ct_x, ct_y, ct_s))
    lo = 5 * mesh.rank
    return {"entered": entered.detach(), "want_entered": mine[0],
            "gx": gx, "want_gx": all_[0][1] + all_[1][1],
            "joined": joined.detach(), "want_joined": all_[0][2] + all_[1][2],
            "gy": gy, "want_gy": mine[3],
            "gathered": gathered.detach(), "want_gathered": torch.cat([all_[0][4], all_[1][4]], 1),
            "gs": gs, "want_gs": all_[0][5][:, lo:lo + 5] + all_[1][5][:, lo:lo + 5]}


def leaf_gather_unit(mesh) -> dict:
    """``LeafGather`` on this rank's bf16 (3, 5, 4) shard along dim 1:
    forward against the ranks' shards concatenated there, the shard's
    gradient for a per-rank cotangent against the sum of the ranks'
    cotangents' parts on this rank's columns."""
    import torch

    from repro_torch.core.zero import LeafGather

    def draw(r):
        gen = torch.Generator().manual_seed(20 + r)
        return (torch.randn(3, 5, 4, generator=gen).to(torch.bfloat16),
                torch.randn(3, 5 * mesh.world, 4, generator=gen).to(torch.bfloat16))

    shards, cts = zip(*(draw(r) for r in range(mesh.world)))
    shard = shards[mesh.rank].clone().requires_grad_()
    leaf = LeafGather.apply(shard, mesh, 1)
    (grad,) = torch.autograd.grad(leaf, shard, cts[mesh.rank])
    want_grad = cts[0][:, 5 * mesh.rank:5 * (mesh.rank + 1)]
    for ct in cts[1:]:  # the sum in rank order, rounded to bf16 at each add
        want_grad = want_grad + ct[:, 5 * mesh.rank:5 * (mesh.rank + 1)]
    return {"leaf": leaf.detach(), "want_leaf": torch.cat(shards, dim=1), "grad": grad,
            "want_grad": want_grad}


def job_plan(tmp: str, mesh, argv=PLAN_ARGV) -> dict:
    """``launch.train --plan auto --hw-devices 2`` in this rank's group
    (``argv``, by default ``PLAN_ARGV``): its plan, resolved run and
    losses."""
    from repro_torch.launch import train

    argv = argv + ["--nvme-dir", os.path.join(tmp, "plan_nvme"),
                   "--ckpt-dir", os.path.join(tmp, "plan_ck")]
    hist = train.train(train.build_argparser().parse_args(argv), argv)
    return {"plan": hist["plan"].to_json(), "run": dataclasses.asdict(hist["run"]),
            "losses": hist["losses"], "metrics": hist["metrics"]}


# ---------------------------------------------------------------------------
# job dp_moe: the layered epoch's MoE and q8/q4 rows, the GSPMD engine's MoE
# ---------------------------------------------------------------------------


def layered_cfg(case: str, package):
    """``case``'s model config from ``package``'s ``configs``."""
    _, arch, d_model, _ = LAYERED_CASES[case]
    cut = {"n_layers": 2}
    if d_model is not None:
        cut["d_model"] = d_model
    return dataclasses.replace(package.smoke(arch), **cut)


def layered_run(case: str, nvme_dir: str):
    from repro_torch import configs
    from repro_torch.config import RunConfig, TrainConfig, make_offload, make_parallel

    quant = LAYERED_CASES[case][3]
    return RunConfig(model=layered_cfg(case, configs),
                     parallel=make_parallel("zero3", remat="none"),
                     offload=make_offload(param_tier="nvme", grad_tier="nvme", opt_tier="nvme",
                                          nvme_dir=nvme_dir, param_quant=quant),
                     train=TrainConfig(lr=LR, warmup_steps=WARMUP))


def layered_init_path(tmp: str, case: str) -> str:
    """Where the test saves ``case``'s global initial state: the
    reference's tier-independent leaves (``flat`` and, for MoE, ``eflat``
    padded for the case's dp), as the port's tensors."""
    return os.path.join(tmp, f"layered_init_{case}.pt")


def opt_states(ex) -> dict:
    """Every key of the rank's opt store: ``(master, m, v)`` f32, read
    back chunk by chunk."""
    import torch

    off = ex.offload
    off.store.flush()

    def read(key, what, n):
        return torch.cat([off.store.read(f"{key}.{what}.{ci}").result().reshape(-1)
                          for ci in range(-(-n // off.chunk))])

    return {key: tuple(read(key, w, n) for w in ("master", "m", "v"))
            for key, _, n in off.layout}


def run_layered_case(case: str, tmp: str, mesh) -> dict:
    """``STEPS`` steps of ``case`` on this rank (``mesh``: one rank for the
    test's one-rank runs) from the global initial state at
    ``layered_init_path``, each rank its slices (``bridge``), on the rank's
    rows of the global batches: per step metrics, then the rank's rows
    read back from the param store, its opt store (keys and states),
    'other' and the step count."""
    import torch

    from repro_torch import bridge
    from repro_torch.config import ShapeConfig
    from repro_torch.core import executor as texec
    from repro_torch.data import pipeline as tpipe

    run = layered_run(case, os.path.join(tmp, case, f"torch_w{mesh.world}"))
    ex = texec.InfinityExecutor(run, "cpu", mesh=mesh if mesh.world > 1 else None)
    init = torch.load(layered_init_path(tmp, case), weights_only=False)
    state = bridge.shard_zero3_state(init, mesh.rank, mesh.world)
    state = ex.reseed(ex.engine.place_state(ex.engine.complete_state(state)))
    stream = tpipe.SyntheticStream(ex.input_specs(ShapeConfig("t", S, B, "train")),
                                   run.model.vocab_size, seed=0)
    step = ex.make_train_step()
    metrics = []
    for i in range(STEPS):
        batch = tpipe.rank_slice(stream.batch_at(i), mesh.rank, mesh.world)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append({k: host_metric(v) for k, v in m.items()})
    rows = ex.materialize_rows()
    out = {"metrics": metrics, "rows": {k: v.float().clone() for k, v in rows.items()},
           "other": state["other"], "step": int(state["step"]),
           "opt": opt_states(ex), "opt_keys": sorted(ex.opt_store.keys()),
           "quantized_leaves": ex.engine.quantized_leaves}
    ex.close()
    return out


def wire_gather_unit(mesh) -> dict:
    """Each rank's q8 wire row of a (101,) slice (its last block ragged):
    the device operands (``qformat.wire_row_device``), all-gathered as the
    layered epoch gathers them (int8 quants, fp16 scales), beside every
    rank's own encode (``q8_encode``) of its slice."""
    import torch

    from repro_torch.core import qformat
    from repro_torch.core.offload import PinnedBufferPool, PinnedStager

    def piece(r):
        return torch.randn(101, generator=torch.Generator().manual_seed(30 + r)) * (r + 1)

    stager = PinnedStager(PinnedBufferPool(1 << 20, pin=False), torch.device("cpu"))
    q, s = qformat.wire_row_device(qformat.encode_array(piece(mesh.rank), "q8"), stager)
    got_q, got_s = mesh.all_gather(q), mesh.all_gather(s)
    encodes = [qformat.q8_encode(piece(r)) for r in range(mesh.world)]
    return {"q": got_q, "s": got_s, "want_q": torch.cat([e[0].reshape(-1) for e in encodes]),
            "want_s": torch.cat([e[1] for e in encodes])}


def wave_vjp_unit(mesh) -> dict:
    """The layered epoch's ``moe_wave_vjp`` at dp 2 on the smoke granite
    (each rank its own tokens, the wave's (W, Pe/2) slices of the same
    rows) against the one-rank piece on the rank's tokens and the whole
    rows: the expert rows' gradient is the dim-1 reduce-scatter, in bf16,
    of the ranks' whole-row cotangents (each rank's the one-rank piece's),
    upcast after; the router's the f32 sum of theirs."""
    import torch

    from repro_torch import configs
    from repro_torch.core.zero import ExplicitZero3Engine

    run = layered_run("moe_layered_dp2", "")
    engines = {w: ExplicitZero3Engine(run, "cpu", mesh if w > 1 else None) for w in (1, 2)}
    fns = {w: e.make_layer_fns() for w, e in engines.items()}
    cfg = configs.smoke("granite-moe-1b-a400m")
    eng = engines[1]
    W, P, Pe = cfg.top_k, eng.layout.padded, eng.elayout.padded
    gen = torch.Generator().manual_seed(40)
    row = (torch.randn(P, generator=gen) * 0.1).to(torch.bfloat16)
    erows = (torch.randn(W, Pe, generator=gen) * 0.1).to(torch.bfloat16)
    router = torch.randn(cfg.d_model, cfg.n_experts, generator=gen) * 0.1
    gen_r = torch.Generator().manual_seed(50 + mesh.rank)
    x_mid = torch.randn(1, S, cfg.d_model, generator=gen_r).to(torch.bfloat16)
    dy = torch.randn(1, S, cfg.d_model, generator=gen_r).to(torch.bfloat16)
    ids = torch.arange(W, dtype=torch.int64)
    mask = torch.ones(W, dtype=torch.float32)
    half, ehalf = P // 2, Pe // 2
    two = fns[2]["moe_wave_vjp"](x_mid, row[mesh.rank * half:(mesh.rank + 1) * half], router,
                                 erows[:, mesh.rank * ehalf:(mesh.rank + 1) * ehalf].contiguous(),
                                 ids, mask, dy)
    # the one-rank piece's bf16 cotangent of the whole rows: its f32 output
    # is the bf16 value upcast
    one = fns[1]["moe_wave_vjp"](x_mid, row, router, erows, ids, mask, dy)
    ct = mesh.gather_stack(one[3].to(torch.bfloat16))
    drt = mesh.gather_stack(one[2])
    want = ct[0, :, mesh.rank * ehalf:(mesh.rank + 1) * ehalf]
    for c in ct[1:]:
        want = want + c[:, mesh.rank * ehalf:(mesh.rank + 1) * ehalf]
    return {"der": two[3], "want_der": want.float(), "drt": two[2], "want_drt": drt[0] + drt[1]}


def job_dp_moe(tmp: str, mesh) -> dict:
    """Every layered case at this world size, then, at 2 ranks, the GSPMD
    engine's MoE cases and the units (the wire gather, the wave's
    backward)."""
    out = {case: run_layered_case(case, tmp, mesh) for case, spec in LAYERED_CASES.items()
           if spec[0] == mesh.world}
    if mesh.world == 2:
        out.update({case: run_gspmd_case(case, tmp, mesh)
                    for case, spec in MOE_GSPMD_CASES.items() if spec[0] == 2})
        out["wire_gather"] = wire_gather_unit(mesh)
        out["wave_vjp"] = wave_vjp_unit(mesh)
    return out


# ---------------------------------------------------------------------------
# job serve: launch.serve on the ranks
# ---------------------------------------------------------------------------


def serve_cfg(case: str, package):
    """``case``'s model config from ``package``'s ``configs``."""
    _, arch, layers, _ = ALL_SERVE_CASES[case]
    cfg = package.smoke(arch)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def serve_argv(case: str, side: str, tmp: str) -> list:
    """``case``'s serve flags for ``side`` ("torch": the port, on the CPU,
    its ranks from ``--data-mesh`` or the plan's ``--hw-devices``; "jax":
    the reference, whose mesh is ``--data-mesh`` alone)."""
    dp, arch, layers, extra = ALL_SERVE_CASES[case]
    argv = ["--arch", arch, *SERVE_ARGV, "--prompt-len", str(SERVE_PROMPT.get(arch, 8)),
            *extra, "--kv-dir", os.path.join(tmp, case, side)]
    if case in SERVE_CASES and (side == "jax" or "--plan" not in extra):
        argv += ["--data-mesh", str(dp)]
    if side == "torch":
        argv += ["--device", "cpu"] + (["--layers", str(layers)] if layers else [])
    return argv


def serve_strategy(case: str) -> str:
    """``case``'s forced attention strategy ("auto" where none is)."""
    return SERVE_STRATEGY.get(case, "auto")


def serve_init_path(tmp: str, case: str) -> str:
    """Where the test saves ``case``'s params: the reference bundle's init
    at one device, as the port's whole tensors."""
    return os.path.join(tmp, f"serve_init_{case}.pt")


def layer_gather_unit(eng, whole: dict) -> dict:
    """The rank's shards of ``whole`` read through ``serve_params``: each
    stacked subtree's ``layer(l)`` against ``layer_params`` of the whole
    leaves, each unstacked leaf against the whole leaf (``torch.equal``;
    on a model axis the rank's model shard of it: tensor parallelism
    gathers over the data axis alone, context parallelism the leaves it
    uses whole over the model axis too); and what the rank holds of each
    stacked leaf."""
    import torch

    from repro_torch.core import partition as pt
    from repro_torch.models.transformer import layer_params

    shards = eng.respec(whole, None, "param")
    view = eng.serve_params(shards)
    M, m = eng.sizes["model"], eng.coords["model"]
    whole = pt.tree_map(lambda t: t, whole)  # a copy of the tree, not of the leaves
    for path in pt.tree_paths(whole):  # the rank's model shard of each leaf
        # (context parallelism's view holds the leaves it gathers whole)
        dim = None if eng._whole_over_model(path) is not None else pt.tree_get(
            eng.model_splits, path)
        pt.tree_set(whole, path, pt.shard_leaf(pt.tree_get(whole, path), dim, m, M))
    equal, split = True, []
    for k in sorted(whole):
        if k in eng.stacked:
            for l in range(pt.tree_leaves(whole[k])[0].shape[0]):
                got, want = layer_params(view[k], l), layer_params(whole[k], l)
                equal &= all(torch.equal(pt.tree_get(got, p), pt.tree_get(want, p))
                             for p in pt.tree_paths(want))
            for p in pt.tree_paths(whole[k]):
                if pt.tree_get(eng.splits["param"][k], p) is not None:
                    split.append((k,) + p)
        else:
            equal &= all(torch.equal(pt.tree_get(view[k], p), pt.tree_get(whole[k], p))
                         for p in pt.tree_paths(whole[k]))
    held = {(k,) + p: tuple(pt.tree_get(shards[k], p).shape) for k in eng.stacked
            for p in pt.tree_paths(shards[k])}
    return {"equal": equal, "stacked": list(eng.stacked), "split_stacked": split,
            "held_shapes": held}


def _serve_engine(case: str, mesh):
    """The engine ``launch.serve`` builds for ``case`` on this rank's mesh
    (on the CPU: no collective is issued building it)."""
    from repro_torch import configs
    from repro_torch.config import ParallelConfig, RunConfig
    from repro_torch.core.engine import ZeroInfinityEngine

    return ZeroInfinityEngine(RunConfig(model=serve_cfg(case, configs),
                                        parallel=ParallelConfig(
                                            remat="none", attn_strategy=serve_strategy(case))),
                              "cpu", mesh=mesh)


def run_serve_case(case: str, tmp: str, mesh) -> dict:
    """``launch.serve`` with ``case``'s flags on this rank's group, its
    params the rank's shards of the saved whole params; the run's
    numbers, the engine's ``shard_bytes`` and ``layer_gather_unit``."""
    import torch

    from repro_torch.core import partition as pt
    from repro_torch.launch import serve

    whole = torch.load(serve_init_path(tmp, case), weights_only=False)
    argv = serve_argv(case, "torch", tmp)
    real = serve.ZeroInfinityEngine.init_params
    serve.ZeroInfinityEngine.init_params = lambda self, gen: self.respec(
        pt.tree_map(lambda t: t.to(self.device), whole), None, "param")
    try:  # the strategy in the run's config, as the reference's
        out = serve.run_serve(serve._parse(argv), argv, attn_strategy=serve_strategy(case))
    finally:
        serve.ZeroInfinityEngine.init_params = real
    eng = _serve_engine(case, mesh)
    rec = {k: out[k] for k in ("generated", "done", "slots", "steps", "admissions", "kv",
                               "kv_ranks", "admissions_ranks", "param_shard_bytes", "mesh")}
    rec["plan"] = out["plan"].to_json() if out["plan"] is not None else None
    rec["plan_devices"] = out["plan"].hardware.n_devices if out["plan"] is not None else None
    rec["shard_bytes"] = eng.shard_bytes()["param_shard_bytes"]
    rec["whole_bytes"] = sum(t.numel() * t.element_size() for t in pt.tree_leaves(whole))
    rec["gather"] = layer_gather_unit(eng, whole)
    return rec


def job_serve(tmp: str, mesh) -> dict:
    """Every serving case at this world size."""
    return {case: run_serve_case(case, tmp, mesh) for case, spec in SERVE_CASES.items()
            if spec[0] == mesh.world}


def teacher_tokens(n_seqs: int, vocab: int) -> np.ndarray:
    """The (``n_seqs``, ``TEACHER_STEPS``) tokens the teacher-forced
    decode feeds the prompts (the test feeds the reference the same)."""
    return np.random.default_rng(7).integers(0, vocab, (n_seqs, TEACHER_STEPS), dtype=np.int32)


def teacher_forced(eng, params, full: dict, cap: int, tokens) -> list:
    """Every prompt through ``prefill`` on the rank's shards, its cache
    laid out as ``launch.serve`` lays out the slot cache for ``cap``
    positions (``kvcache.decode_positions``: under context parallelism the
    rank's range where ``cap`` splits), then ``tokens``' columns one decode
    step each: the last position's logits of each call, the global vocab
    (the vocab shards all-gathered over the model ranks where they are
    split)."""
    import torch

    from repro_torch.core import kvcache
    from repro_torch.models import common as cm

    mp = eng.mp
    with torch.no_grad():
        view = eng.serve_params(params)
        sharded = mp is not None and cm.vocab_sharded(view["embed"], eng.run.model, mp)

        def whole(lg):
            lg = lg[:, -1].float()
            return eng.mesh.all_gather(lg, 1, "model") if sharded else lg

        lg, cache = eng.bundle.prefill(view, full)
        P, B = int(cache["len"]), lg.shape[0]
        cache, own, n, split = kvcache.decode_positions(cache, mp, cap)
        cache = kvcache.grow_cache(cache, n - own, eng.run.model.family)
        cache["len"] = torch.full((B,), P, dtype=torch.int32)
        out = [whole(lg)]
        for i in range(tokens.shape[1]):
            kw = {"seq_split": True} if split else {}
            lg, cache = eng.bundle.decode_step(eng.serve_params(params), cache,
                                               {"tokens": torch.from_numpy(
                                                   np.ascontiguousarray(tokens[:, i:i + 1]))},
                                               **kw)
            out.append(whole(lg))
    return out


def run_tp_serve_case(case: str, tmp: str, mesh) -> dict:
    """``run_serve_case`` on a model axis, and the teacher-forced logits
    (``teacher_forced``: the prompts' prefill, then ``TEACHER_STEPS``
    decode steps of ``teacher_tokens``) at the run's capacity."""
    import torch

    from repro_torch.config import ShapeConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve

    args = serve._parse(serve_argv(case, "torch", tmp))
    tmesh = mesh_mod.make_local_mesh(args.data_mesh, args.model_mesh, "cpu")
    rec = run_serve_case(case, tmp, tmesh)
    eng = _serve_engine(case, tmesh)
    whole = torch.load(serve_init_path(tmp, case), weights_only=False)
    params = eng.respec(whole, None, "param")
    cfg = eng.run.model
    full = serve.draw_inputs(eng.bundle.input_specs(ShapeConfig("serve", args.prompt_len,
                                                                args.batch, "prefill")),
                             args.batch, cfg.vocab_size, args.seed)
    # the prompt counts a VLM's vision positions; an encoder-decoder's cache
    # holds its decoder tokens (launch.serve)
    prompt = full["tokens"].shape[1] if cfg.family == "encdec" else args.prompt_len
    forced = teacher_forced(eng, params, full, prompt + args.new_tokens,
                            teacher_tokens(args.batch, cfg.vocab_size))
    rec["prefill_logits"], rec["decode_logits"] = forced[0], forced[1:]
    defs = eng.bundle.cache_defs(1, 1)
    rec["kv_heads"] = defs["k"].shape[3] if "k" in defs else None
    rec["mesh_shape"] = (tmesh.data, tmesh.model)
    return rec


def job_tp_serve(tmp: str, mesh) -> dict:
    """Every tensor-parallel serving case of this world size."""
    return {case: run_tp_serve_case(case, tmp, mesh)
            for case, spec in TP_SERVE_CASES.items() if spec[0] == mesh.world}


def job_cp_serve(tmp: str, mesh) -> dict:
    """Every context-parallel serving case of this world size."""
    return {case: run_tp_serve_case(case, tmp, mesh)
            for case, spec in CP_SERVE_CASES.items() if spec[0] == mesh.world}


def job_moe_tp(tmp: str, mesh) -> dict:
    """Every MoE model-axis case of this world size, each on a mesh of its
    own, then its MoE serving cases."""
    from repro_torch.launch import mesh as mesh_mod

    out = {}
    for case, (D, M, *_) in MOE_TP_CASES.items():
        if D * M == mesh.world and M > 1:
            out[case] = run_gspmd_case(case, tmp, mesh_mod.make_local_mesh(D, M, "cpu"))
    out.update({case: run_tp_serve_case(case, tmp, mesh)
                for case, spec in MOE_SERVE_CASES.items() if spec[0] == mesh.world})
    return out


def job_recurrent_tp(tmp: str, mesh) -> dict:
    """Every recurrent model-axis case of this world size, each on a mesh
    of its own, then its serving cases and, at 2 ranks, the model-axis
    sum's unit (``model_sum_unit``)."""
    from repro_torch.launch import mesh as mesh_mod

    out = {}
    for case, (D, M, *_) in RECURRENT_TP_CASES.items():
        if D * M == mesh.world and M > 1:
            out[case] = run_gspmd_case(case, tmp, mesh_mod.make_local_mesh(D, M, "cpu"))
    out.update({case: run_tp_serve_case(case, tmp, mesh)
                for case, spec in RECURRENT_SERVE_CASES.items() if spec[0] == mesh.world})
    if mesh.world == 2:
        out["model_sum"] = model_sum_unit(mesh_mod.make_local_mesh(1, 2, "cpu"))
    return out


def model_sum_unit(mesh) -> dict:
    """``ModelAxis.sum`` on a (1, 2) mesh, f32: the ranks' draws summed,
    and the gradient of a loss that uses the sum on the rank's own part
    (``sum(ct * s)`` with a per-rank cotangent ``ct``): the ranks'
    cotangents summed, which ``FromModel``'s identity backward (``join``)
    gives only the rank's own of; and ``rms_norm_split`` over two ranks'
    halves of a row against ``rms_norm`` of the whole row, value and
    gradient, each rank its half."""
    import torch

    from repro_torch.core.zero import ModelAxis
    from repro_torch.models import common as cm

    mp = ModelAxis(mesh, "tp")

    def draw(r):
        gen = torch.Generator().manual_seed(70 + r)
        return [torch.randn(*s, generator=gen) for s in ((3, 1), (3, 1))]

    mine, all_ = draw(mesh.rank), [draw(r) for r in range(2)]
    x = mine[0].clone().requires_grad_()
    summed = mp.sum(x)
    (gx,) = torch.autograd.grad(summed, x, mine[1])
    y = mine[0].clone().requires_grad_()
    (gy,) = torch.autograd.grad(mp.join(y), y, mine[1])
    gen = torch.Generator().manual_seed(80)
    row = torch.randn(3, 8, generator=gen).to(torch.bfloat16)
    scale = torch.randn(8, generator=gen) * 0.1
    ct = torch.randn(3, 8, generator=gen).to(torch.bfloat16)
    lo, hi = 4 * mesh.rank, 4 * (mesh.rank + 1)
    half = row[:, lo:hi].clone().requires_grad_()
    got = cm.rms_norm_split(half, scale[lo:hi], mp)
    (g_half,) = torch.autograd.grad(got, half, ct[:, lo:hi])
    whole = row.clone().requires_grad_()
    want = cm.rms_norm(whole, scale)
    (g_whole,) = torch.autograd.grad(want, whole, ct)
    return {"summed": summed.detach(), "want_summed": all_[0][0] + all_[1][0],
            "gx": gx, "want_gx": all_[0][1] + all_[1][1], "join_gx": gy,
            "norm": got.detach(), "want_norm": want.detach()[:, lo:hi],
            "norm_grad": g_half, "want_norm_grad": g_whole[:, lo:hi]}


def job_encdec_tp(tmp: str, mesh) -> dict:
    """Every encoder-decoder model-axis case of this world size, each on a
    mesh of its own, then its serving cases and, at 2 ranks, the units
    (``encdec_unit``) and the plan's run on the model axis
    (``ENCDEC_PLAN_ARGV``)."""
    from repro_torch.launch import mesh as mesh_mod

    out = {}
    for case, (D, M, *_) in ENCDEC_TP_CASES.items():
        if D * M == mesh.world:
            out[case] = run_gspmd_case(case, tmp, mesh_mod.make_local_mesh(D, M, "cpu"))
    out.update({case: run_tp_serve_case(case, tmp, mesh)
                for case, spec in ENCDEC_SERVE_CASES.items() if spec[0] == mesh.world})
    if mesh.world == 2:
        out["encdec_unit"] = encdec_unit(mesh_mod.make_local_mesh(1, 2, "cpu"))
        out["plan"] = job_plan(tmp, mesh, ENCDEC_PLAN_ARGV)
    return out


def encdec_unit(mesh) -> dict:
    """On a (1, 2) mesh, the smoke seamless: the loss's gradient in the
    frames under tensor parallelism (the rank's model shards of one draw)
    against the one-rank bundle's, which the memory's cotangent, summed
    over the model ranks where it enters the model axis, carries into the
    encoder; and under context parallelism the rank's chunk through
    ``attention_block``, not causal (the encoder's), as a cross-attention
    (the memory's chunk) and causal (the decoder's), against the rows of
    the whole sequence's output at one rank, the rank's rows."""
    import torch

    from repro_torch import configs
    from repro_torch.config import RunConfig, make_parallel
    from repro_torch.core import partition as pt
    from repro_torch.core.engine import ZeroInfinityEngine
    from repro_torch.core.zero import ModelAxis
    from repro_torch.models import common as cm
    from repro_torch.models import registry

    cfg = configs.smoke("seamless-m4t-medium")
    whole = registry.build(cfg).init(torch.Generator().manual_seed(11), "cpu")
    gen = torch.Generator().manual_seed(12)
    B, E, d = 2, 16, cfg.d_model
    T = E // 4
    frames = torch.randn(B, E, d, generator=gen).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, dtype=torch.int32)
    batch = {"frames": frames, "tokens": tokens, "labels": tokens}

    def frames_grad(bundle, params):
        f = frames.clone().requires_grad_()
        loss = bundle.loss(params, {**batch, "frames": f})
        return loss.detach(), torch.autograd.grad(loss, f)[0]

    want_loss, want_grad = frames_grad(registry.build(cfg), whole)
    eng = ZeroInfinityEngine(RunConfig(model=cfg, parallel=make_parallel("pjit", remat="none")),
                             "cpu", mesh=mesh)
    loss, grad = frames_grad(eng.bundle, eng.respec(whole, None, "param"))
    out = {"strategy": eng.mp.strategy, "loss": loss, "want_loss": want_loss, "grad": grad,
           "want_grad": want_grad}

    mp = ModelAxis(mesh, "cp")
    enc = pt.tree_map(lambda t: t[0], whole["enc"]["attn"])
    cross = pt.tree_map(lambda t: t[0], whole["dec"]["cross_attn"])
    x = torch.randn(B, E, d, generator=gen).to(torch.bfloat16)
    y = torch.randn(B, T, d, generator=gen).to(torch.bfloat16)
    pos_x = torch.arange(E)[None].expand(B, E)
    pos_y = torch.arange(T)[None].expand(B, T)
    xl, xh = mesh.rank * E // 2, (mesh.rank + 1) * E // 2
    yl, yh = mesh.rank * T // 2, (mesh.rank + 1) * T // 2
    with torch.no_grad():
        for name, p, q, pos, (lo, hi), causal, src in (
                ("encoder", enc, x, pos_x, (xl, xh), False, None),
                ("cross", cross, y, pos_y, (yl, yh), False, x),
                ("causal", enc, x, pos_x, (xl, xh), True, None)):
            want, _ = cm.attention_block(p, q, pos, cfg, causal=causal, kv_source=src)
            got, _ = cm.attention_block(p, q[:, lo:hi], pos[:, lo:hi], cfg, causal=causal,
                                        kv_source=None if src is None else src[:, xl:xh],
                                        mp=mp)
            out[name], out[f"want_{name}"] = got, want[:, lo:hi]
    return out


def job_nvme_mesh(tmp: str, mesh) -> dict:
    """Every NVMe-param case of this world size, each on a mesh of its
    own."""
    from repro_torch.launch import mesh as mesh_mod

    return {case: run_gspmd_case(case, tmp, mesh_mod.make_local_mesh(D, M, "cpu"))
            for case, (D, M, *_) in NVME_MESH_CASES.items() if D * M == mesh.world}


# ---------------------------------------------------------------------------
# jobs ckpt_mesh and ckpt_restore: checkpoints on the ranks
# ---------------------------------------------------------------------------

# the checkpointed states (tests/test_torch_checkpoint_mesh.py): case ->
# (engine, data, model, d_model (None: the smoke width), param, grad, opt
# tiers, grad_compression), the smoke smollm at 2 layers, ZeRO-3. d_model 47
# gives the explicit engine's rows P = 24,158: unpadded at dp 2, padded to
# 24,160 at dp 4 (two zeros in rank 3's slice)
CKPT_CASES = {
    "g_device_2x1": ("pjit", 2, 1, None, "device", "device", "device", "none"),
    "g_nvme_2x1": ("pjit", 2, 1, None, "nvme", "nvme", "nvme", "none"),
    "g_device_1x2": ("pjit", 1, 2, None, "device", "device", "device", "none"),
    "g_nvme_1x2": ("pjit", 1, 2, None, "nvme", "device", "device", "none"),
    "z_int8_dp2": ("zero3", 2, 1, 47, "device", "device", "device", "int8"),
    "z_layered_dp2": ("zero3", 2, 1, None, "nvme", "nvme", "nvme", "none"),
    "z_dp4": ("zero3", 4, 1, 47, "device", "device", "device", "none"),
}
# the re-sharding restores: (source case, data, model of the restoring mesh)
RESHARDS = [("g_device_2x1", 1, 1), ("g_device_2x1", 1, 2), ("g_device_2x1", 2, 2),
            ("z_dp4", 1, 1), ("z_dp4", 2, 1), ("z_int8_dp2", 4, 1)]
# the training CLI's flags on both sides (GSPMD, in-graph, on (2, 1))
CKPT_ARGV = ["--smoke", "--engine", "pjit", "--data-mesh", "2", "--batch", "4", "--seq", "16",
             "--lr", "3e-3", "--log-every", "100"]


def ckpt_cfg(case: str, package):
    d_model = CKPT_CASES[case][3]
    return dataclasses.replace(package.smoke("smollm-135m"), n_layers=2,
                               **({} if d_model is None else {"d_model": d_model}))


def ckpt_run(case: str, nvme_dir: str):
    """``case``'s port RunConfig at its tiers, the stores under
    ``nvme_dir``."""
    from repro_torch import configs
    from repro_torch.config import RunConfig, TrainConfig, make_offload, make_parallel

    engine, _, _, _, param, grad, opt, compress = CKPT_CASES[case]
    return RunConfig(model=ckpt_cfg(case, configs),
                     parallel=make_parallel(engine, remat="none", grad_compression=compress),
                     offload=make_offload(param_tier=param, grad_tier=grad, opt_tier=opt,
                                          nvme_dir=nvme_dir),
                     train=TrainConfig(lr=LR, warmup_steps=WARMUP))


def ckpt_path(tmp: str, case: str, side: str) -> str:
    """Where ``side`` ("torch", "jax", or a re-shard's name) checkpoints
    ``case``'s state."""
    return os.path.join(tmp, "ck", case, side)


def ckpt_init_path(tmp: str, case: str) -> str:
    """Where the test saves ``case``'s global initial state: the GSPMD
    cases' whole params, the explicit cases' tier-independent leaves (rows
    padded for the case's dp), as the port's tensors."""
    engine, dp, _, d_model = CKPT_CASES[case][:4]
    return os.path.join(tmp, f"ckpt_init_{engine}_{d_model or 'smoke'}"
                             f"{'_dp' + str(dp) if engine == 'zero3' else ''}.pt")


def _ckpt_state(case: str, tmp: str, mesh, ex) -> dict:
    """The rank's part of ``case``'s global initial state, placed and the
    stores seeded (Adam's state from the params as both inits build it)."""
    import torch

    from repro_torch import bridge
    from repro_torch.optim import adam

    init = torch.load(ckpt_init_path(tmp, case), weights_only=False)
    if not ex.explicit:
        full = {"params": init}
        if not ex.run.opt_offgraph:
            full["opt"] = adam.init_state(init)
        return ex.reseed(ex.engine.place_state(
            bridge.shard_gspmd_state(full, ex.run, mesh.rank, mesh.data, mesh.model)))
    state = bridge.shard_zero3_state(init, mesh.rank, mesh.world)
    return ex.reseed(ex.engine.place_state(ex.engine.complete_state(state)))


def _save_rank0(snapshot, path: str, extra: dict) -> None:
    from repro_torch.checkpoint.manager import CheckpointManager

    if snapshot is not None:
        CheckpointManager(path, async_save=False).save(0, snapshot, extra)


def run_ckpt_case(case: str, tmp: str, mesh) -> dict:
    """``case``'s initial state on this rank, checkpointed (rank 0 writes
    the global leaves) into ``ckpt_path(..., "torch")``."""
    from repro_torch.core import executor as texec

    ex = texec.InfinityExecutor(ckpt_run(case, os.path.join(tmp, "nv", case, "torch")), "cpu",
                                mesh=mesh if mesh.world > 1 else None)
    snap = ex.checkpoint_state(_ckpt_state(case, tmp, mesh, ex))
    _save_rank0(snap, ckpt_path(tmp, case, "torch"), {"next_step": 0})
    ex.close()
    return {"saved": snap is not None}


def reshard_name(data: int, model: int) -> str:
    return f"torch_{data}x{model}"


def reshard(case: str, tmp: str, mesh) -> dict:
    """``case``'s checkpoint restored on this rank's mesh (another data or
    model size; the explicit engine's rows re-padded for its dp) at the
    case's tiers, then checkpointed again at once into
    ``ckpt_path(case, reshard_name(...))``."""
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import executor as texec

    name = reshard_name(mesh.data, mesh.model)
    ex = texec.InfinityExecutor(ckpt_run(case, os.path.join(tmp, "nv", case, name)), "cpu",
                                mesh=mesh if mesh.world > 1 else None)
    state = ex.init_state(torch.Generator().manual_seed(0), seed_stores=False)
    restored, extra = CheckpointManager(ckpt_path(tmp, case, "torch")).restore(state, step=0)
    state = ex.restore_state(restored, step=extra["next_step"])
    _save_rank0(ex.checkpoint_state(state), ckpt_path(tmp, case, name), extra)
    ex.close()
    return {"name": name}


def run_cli(argv: list, env: dict = None) -> dict:
    """``launch.train`` with ``argv`` on this rank's group (``env`` set
    around it): its losses, step numbers and restarts."""
    from repro_torch.launch import train

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        hist = train.train(train.build_argparser().parse_args(argv), argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"losses": hist["losses"], "steps": [m["step"] for m in hist["metrics"]],
            "restarts": hist["restarts"], "checkpoint": hist["checkpoint"]}


def cli_argv(tmp: str, name: str, steps: int, every: int, extra=()) -> list:
    return CKPT_ARGV + ["--device", "cpu", "--steps", str(steps), "--ckpt-every", str(every),
                        "--ckpt-dir", os.path.join(tmp, "cli", name),
                        "--nvme-dir", os.path.join(tmp, "nv", "cli", name), *extra]


def params_from_state_unit(tmp: str, mesh) -> dict:
    """The explicit engine's ``params_from_state`` on this rank's rows of
    ``z_int8_dp2``'s initial state (dp 2) beside a one-rank engine's of the
    global state."""
    import torch

    from repro_torch import bridge
    from repro_torch.core.zero import ExplicitZero3Engine

    run = ckpt_run("z_int8_dp2", "")
    init = torch.load(ckpt_init_path(tmp, "z_int8_dp2"), weights_only=False)
    two = ExplicitZero3Engine(run, "cpu", mesh)
    one = ExplicitZero3Engine(run, "cpu")
    return {"dp2": two.params_from_state(bridge.shard_zero3_state(init, mesh.rank, 2)),
            "dp1": one.params_from_state(init)}


def job_ckpt_mesh(tmp: str, mesh) -> dict:
    """Phase one: every checkpoint case of this world size; at 2 ranks
    also the CLI run the reference restores (3 steps, a checkpoint at step
    2), the restart drill (a checkpoint every step, a failure at step 2,
    4 steps) beside its uninterrupted run, and ``params_from_state``."""
    from repro_torch.launch import mesh as mesh_mod

    out = {}
    for case, (_, D, M, *_) in CKPT_CASES.items():
        if D * M == mesh.world:
            out[case] = run_ckpt_case(case, tmp, mesh_mod.make_local_mesh(D, M, "cpu"))
    if mesh.world == 2:
        out["cli"] = run_cli(cli_argv(tmp, "torch", 3, 2))
        out["unbroken"] = run_cli(cli_argv(tmp, "unbroken", 4, 0))
        out["drill"] = run_cli(cli_argv(tmp, "drill", 4, 1, ["--resume", "auto"]),
                               {"REPRO_FAIL_AT_STEP": "2",
                                "REPRO_FAIL_MARKER": os.path.join(tmp, "drill_marker")})
        out["params_from_state"] = params_from_state_unit(tmp, mesh)
    return out


def job_ckpt_restore(tmp: str, mesh) -> dict:
    """Phase two: this world size's re-shards; at 2 ranks also the CLI's
    resume from the reference's checkpoint (one step), the resume past a
    corrupt newest checkpoint, and the tier migration (an off-graph
    checkpoint into an in-graph run: ``adopt_state`` counted)."""
    from repro_torch.core import executor as texec
    from repro_torch.launch import mesh as mesh_mod

    out = {}
    for case, D, M in RESHARDS:
        if D * M == mesh.world:
            out[f"{case}/{D}x{M}"] = reshard(case, tmp, mesh_mod.make_local_mesh(D, M, "cpu"))
    if mesh.world == 2:
        out["cross"] = run_cli(cli_argv(tmp, "jax_into_torch", 3, 0, ["--resume", "auto"]))
        out["fallback"] = run_cli(cli_argv(tmp, "fallback", 5, 0, ["--resume", "auto"]))
        calls = []
        real = texec.InfinityExecutor.adopt_state

        def adopt_state(self, portable, **kw):
            calls.append(sorted(portable))
            return real(self, portable, **kw)

        texec.InfinityExecutor.adopt_state = adopt_state
        try:
            out["migration"] = run_cli(cli_argv(tmp, "migration", 1, 0, ["--resume", "auto"]))
        finally:
            texec.InfinityExecutor.adopt_state = real
        out["migration"]["adopted"] = calls
    return out


JOBS = {"dp": job_dp, "gspmd": job_gspmd, "dp_moe": job_dp_moe, "serve": job_serve,
        "tp": job_tp, "tp_serve": job_tp_serve, "cp_serve": job_cp_serve,
        "moe_tp": job_moe_tp, "recurrent_tp": job_recurrent_tp, "encdec_tp": job_encdec_tp,
        "nvme_mesh": job_nvme_mesh, "ckpt_mesh": job_ckpt_mesh, "ckpt_restore": job_ckpt_restore}


def main() -> None:
    job, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod

    torch.set_num_threads(1)
    name = _name(job, world)
    dist.init_process_group(mesh_mod.choose_backend("cpu", world),
                            init_method=f"file://{os.path.join(tmp, name + '.pg')}",
                            rank=rank, world_size=world, timeout=mesh_mod.TIMEOUT)
    try:
        mesh = mesh_mod.make_local_mesh(world, 1, "cpu")
        torch.save(JOBS[job](tmp, mesh), os.path.join(tmp, f"{name}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""Chip smoke for the PyTorch/Hopper port: builds the CUDA kernels, holds
each against its plain PyTorch version on the card, serves full-width
smollm-135m and granite-moe-1b-a400m through ``repro_torch.launch.serve`` (host and NVMe KV tiers,
and the planner's own placement), trains full smollm-135m through
``repro_torch.launch.train`` with parameters, gradients and optimizer
states on NVMe, in bf16 rows and in q8 wire rows (``--param-quant q8``,
through the quantized-matmul kernel), then with ``--plan auto`` (the
placement the planner derives for the detected card, and the ZeRO-Offload
placement it derives for a starved one), then through the explicit
engine's monolithic step (``--engine zero3`` with params on the device or
the pinned host tier) and a restart drill that resumes from a checkpoint,
then on two data-parallel ranks sharing the card (``--data-mesh 2``: the
explicit engine's rows sharded per rank, the card against the CPU and
the layered epoch on NVMe through ``launch.train``; the GSPMD engine's
leaves sharded per rank at ZeRO-3, the card against the CPU, and full
smollm under ``--plan auto --hw-devices 2``), then trains
granite-moe-1b-a400m under ``--plan auto`` and through the
layered epoch with its expert rows paged from NVMe, then the fixed-state
families: flash attention with recurrentgemma's local window, full
recurrentgemma-9b and mamba2-370m served, recurrentgemma at full width
(5 layers) and full mamba2 trained under ``--plan auto``, then the VLM and
the encoder-decoder: llava-next-34b at full width served (8 layers) and
trained (2 layers), full seamless-m4t-medium served and trained, checks
the outputs, trains full seamless with every state class on NVMe through
the GSPMD leaf scheduler under ``--plan auto --objective min_device_mem``
and under each activation checkpoint policy (``none``, ``full``,
``dots``) all on the device, and prints one JSON line per the contract
below.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from ``src/repro_torch/csrc`` (one nvcc each, in
     parallel), and count the warpgroup MMA (HGMMA) instructions in the
     flash-attention, tiled-matmul and quantized-matmul libraries (none in
     any fails). From before the build one thread computes the CPU sides
     of phases 11, 20 and 25 on the host (``CPU_SIDE_KEYS``); beside it
     run only the phases that read no host clock and trace nothing:
     8, 11, 15, 18's repeat and numerics and 28's numerics on NVMe params,
     in that order, right after the build. Then the thread is joined
     ("phase cpu sides: s", the wait), and phases 3 on run with the host
     to themselves;
  3. each kernel against its plain version at the serve shapes and at a
     ragged shape (flash attention: two), in bf16 and f32, element by element (``TOL``), with
     timings of the bf16 serve shapes (kernel, plain, library yardstick)
     and the least time the card could take (bound); the flash attention's
     and the tiled matmul's routes held (bf16 on the tensor cores, f32 and
     the tiled matmul's ragged shape on the CUDA cores) and their
     tensor-core kernels timed against the CUDA-core ones (``simt_ms``, at
     least ``WGMMA_MIN_SPEEDUP`` faster but at decode);
  4. end-to-end numerics: a 2-layer full-width smollm-135m on the card
     (kernels) against the same weights on the CPU (plain versions),
     teacher-forced prefill + decode logits;
  5. the main path: ``run_serve`` on full smollm-135m (30 layers) with 8
     sequences through 4 device slots, waiting KV on the host tier; launch
     counters are zeroed just before and read just after;
  6. the NVMe KV tier: 3 sequences through 1 slot, once with bf16 KV
     blocks and once with q8 ones (``--kv-quant q8``), counters read again
     for each;
  7. the training kernels against their plain versions: fused Adam at the
     embedding, ``ln_f``, 100,001 elements and the explicit step's (L, P)
     flat (30 x 3,540,096, timed); the flash forward and
     backward (dq, dk, dv; routes held, the tensor-core kernels timed
     against the CUDA-core ones as in 3), at smollm's and at
     granite-moe-1b-a400m's training shapes, also at gemma-7b's and
     nemotron-4-340b's heads (head_dim 256 and 192, on the tensor cores), the
     tiled matmul's gradient products on transposed views (all four
     major-ness combinations, a ragged shape on the tensor cores), and the
     quantized matmul forward and in its dX orientation (routes held, the
     tensor-core kernel timed against the CUDA-core one as in 3), at the
     training shapes and a ragged one (flash: two), bf16 and f32 (``TOL``),
     timed in bf16 at the training shapes;
  8. training numerics: a 2-layer full-width smollm-135m, 2 layered steps
     on the card (kernels) against the CPU (plain versions) from the same
     weights and batches: loss, grad norm, the rows' f32 Adam masters read
     back from the optimizer store and the rows read back from the param
     store; once with bf16 rows, once with q8 wire rows;
  9. the training main path: ``launch.train`` on full smollm-135m (30
     layers), zero3 with params, grads and optimizer states on NVMe, 8
     steps of 8 x 512 tokens, tracer on; launch counters zeroed just before
     and read just after;
  10. the q8 training path: the same run with ``--param-quant q8`` (rows
      cross the tier as q8 frames and the MLP projections run the
      quantized-matmul kernel on them), counters zeroed and read again;
  11. the GSPMD step's numerics: a 2-layer full-width smollm-135m, 2 steps
      of ``--engine pjit`` on the card against the CPU from the same
      weights and batches, in-graph (all on the device), off-graph (the
      optimizer on NVMe, ``remat="full"``) and on the pinned host tier
      (params and optimizer in page-locked CPU memory, ``remat="full"``):
      loss, grad norm, the f32 Adam masters and the params, by
      ``phase_train_numerics``' bounds; the three placements compute one
      function, so the in-graph CPU run is kept (``CPU_RUNS``) and the
      other two cards are held against it;
  12. the planner's main path: ``launch.train --plan auto`` on full
      smollm-135m, 4 steps of 8 x 512 tokens on the detected card, its plan
      printed; fused Adam launches once per leaf per step;
  13. the planner's ZeRO-Offload path: the same argv with ``--hw-device-mem
      3e9`` (``OFFLOAD_DEVICE_MEM``), which the planner answers with the
      optimizer on NVMe off-graph and the params on the device (checked
      against the CPU planner in ``tests/test_torch_plan.py``); every step
      moves the optimizer's bytes, as the plan predicts;
  14. the planner's serving path: ``launch.serve --plan auto`` at the serve
      host cell's sizes, its KV fields printed, every sequence finished and
      the device KV within the plan;
  15. the explicit engine's monolithic step's numerics: a 2-layer
      full-width smollm-135m, 2 steps on the card against the CPU from the
      same state and batches, in-graph, on the pinned host tier (flat and
      optimizer), with the optimizer on NVMe off-graph, and with int8
      gradient compression (``ZERO3_PLACEMENTS``), by phase 11's bounds;
      the in-graph CPU run is kept (``ZERO3_CPU_RUNS``) for the host and
      off-graph placements, int8 runs its own;
  16. its main path: ``launch.train --engine zero3`` on full smollm-135m,
      6 steps of 8 x 512 tokens all on the device, with the optimizer on
      the pinned host tier (the ZeRO-Offload placement) and with params and
      optimizer there; fused Adam on the flat and the two 'other' leaves
      each step;
  16a-16g run after 18, whose kept CPU sides their MoE cases share; one
      spawn of two ranks runs every dp-2 job (``DP_PARTS``, phase "dp2
      ranks") and the phases hold its records:
  16a. "zero3 dp2 numerics": the explicit engine at dp 2, two ranks on the
      one card (torchrun; both on cuda:0 over gloo, ``launch/mesh.py``)
      against two ranks on the CPU, full-width smollm-135m cut to 2
      layers, 2 steps of 4 x 128 tokens (2 a rank) from the same global
      state (each rank its shard) in allgather mode, with int8 compression
      and as the layered epoch with every state class on NVMe; each rank's
      loss, grad norm, rows and f32 masters by phase 15's bounds; then, in
      the same spawn, the layered epoch on the card alone with q8 rows
      (phase 8's model: each rank's slice encoded on its own, gathered as
      int8 quants and fp16 scales into the quantized matmul) and with
      MoE's expert rows (phase 18's 2-layer granite), held against phase
      8's and 18's kept one-rank CPU sides (``DP2_CARD_CASES``);
  16b. "zero3 dp2 train": ``launch.train --engine zero3 --data-mesh 2`` on
      full smollm-135m with params, grads and optimizer on NVMe, two ranks
      on the card, 4 steps of 8 x 512 (4 x 512 a rank), tracer on: each
      rank's tier bytes a step half of phase 9's, their sum over the ranks
      equal to it, the losses phase 9's first four by ``TRAIN_TOL`` and
      falling; each rank's launches, the transport per collective, the
      step wall with its collective waits and each rank's peak allocated
      memory printed. Two ranks on one card check correctness, the
      transport and per-rank memory, not scaling;
  16e. "moe dp2 train" (the same spawn as 16b): ``launch.train --engine
      zero3 --data-mesh 2`` on granite-moe-1b-a400m at full width cut to
      ``MOE_LAYERED_LAYERS``, expert rows paged from NVMe and every state
      class there, ``MOE_TRAIN_STEPS`` steps of 8 x 512: each rank's tier
      and expert bytes half of "moe layered"'s every step and their sums
      equal to them, the losses that run's by ``TRAIN_TOL``, the routing
      statistics equal on both ranks;
  16c. "gspmd dp2 numerics": the GSPMD engine at ZeRO-3 on two ranks on the
      card (gloo), phase 11's model, weights and global batches (each rank
      its shards and rows), in-graph and with the optimizer on NVMe
      off-graph: the params and masters gathered over the ranks and the
      loss and grad norm (summed over them) held against phase 11's kept
      one-rank CPU run by its bounds (rank 0 saves the gathered tensors to
      a file);
  16d. "gspmd dp2 train": ``launch.train --plan auto --hw-devices 2`` on
      full smollm-135m, two ranks on the card, 4 steps of 8 x 512 (4 x 512
      a rank), tracer on: the plan (the GSPMD step, every state on the
      device), each rank's param, grad and opt bytes exactly half of the
      one-rank run's (every leaf splits at d_model 576; a leaf that does
      not is named) and their sums over the ranks equal to it, the plan's
      per-device bytes beside them, the losses phase 12's by ``TRAIN_TOL``,
      each rank's peak allocated memory, the step wall and tokens/s;
  16f. "gspmd moe dp2 train" (the same spawn as 16d): ``--plan auto
      --hw-devices 2`` on granite at ``MOE_LAYERED_LAYERS`` layers,
      ``MOE_TRAIN_STEPS`` steps: each rank's state bytes half the one-rank
      run's, the losses "moe layered"'s (the same weights and batches) by
      ``TRAIN_TOL``, the routing statistics equal on both ranks; 16c also
      holds the GSPMD step on granite at 2 layers on the two ranks against
      phase 18's kept CPU side;
  16g. "serve dp2" (the same spawn): ``launch.serve --data-mesh 2`` on full
      smollm-135m at phase 5's sizes but 8 new tokens (``TP_SERVE_ARGV``: 8
      sequences, 4 slots, 2 a rank, host tier, prompt 512): each rank its
      ZeRO-3 param shards, one layer gathered at a time; every sequence's
      tokens those of a one-rank run of the argv ("tp serve one rank"),
      each rank's param bytes half the one-rank run's, the ``kv`` bytes
      summed over the ranks its, each rank's flash and tiled-matmul
      launches on wgmma as phase 5's; each rank's peak allocated memory and
      the decode step's time printed;
  16h. "cp numerics" (the same spawn): context parallelism, the GSPMD
      engine at ZeRO-3 on a (1, 2) mesh (smollm's 9 heads do not split
      over 2: each rank its half of the sequence, K/V all-gathered), phase
      11's model, weights and global batches: the params and masters
      joined over the ranks, the loss and grad norm held against phase
      11's kept one-rank CPU run by its bounds;
  16i. "cp train" (the same spawn): ``launch.train --engine pjit
      --model-mesh 2`` on full smollm-135m, 3 steps of 8 x 512 (256 of
      the 512 positions of each row a rank): each rank's param bytes
      exactly 161,162,496 (the attention weights and norms whole, the MLP
      and vocab halved), the losses phase 12's by ``TRAIN_TOL``;
  16j. "tp numerics" / "tp train" / "tp serve": one spawn of three ranks
      on the card (``TP3_PARTS``, phase "tp3 ranks"), tensor parallelism
      over 3 (3 heads, 1 KV head, 512 MLP columns and 16,384 vocab rows a
      rank): 16h's check at (1, 3); 16i's run at (1, 3) with 89,793,792
      param bytes a rank; ``launch.serve --model-mesh 3`` on full
      smollm-135m at phase 5's sizes but 8 new tokens (``TP_SERVE_ARGV``;
      every sequence finished, 89,793,792 param bytes a rank, the ``kv``
      bytes summed over the ranks those of a one-rank run of the same
      argv, phase "tp serve one rank", the share of tokens equal to its
      printed), then phase 4's teacher-forced prefill and decode at 2
      layers on the ranks' shards held to phase 4's CPU side by
      ``E2E_REL_TOL``;
  16k. "model axis kernels": flash forward and backward at context
      parallelism's shapes (``FLASH_CP``: 256 queries on 256 and on 512
      keys, causal, the mask aligned at the end; timed beside the bound,
      the CUDA-core kernel, the plain version and SDPA) and at tensor
      parallelism's (``FLASH_TP``: "tp train"'s and "vlm tp4 nccl
      train"'s, granite's 8 heads and 4 KV heads a rank and
      recurrentgemma's 8 heads of 256 with its window of 2048, whose
      records are the windowed kernels', and seamless's 8 heads a rank:
      the encoder's and the cross-attention's, not causal, the decoder's),
      and the tiled matmul at their MLP shards forward and backward
      (``TILED_TP``: recurrentgemma's GeGLU 6144 columns a rank and
      seamless's 2048 at 16384 frames among them),
      bf16, by ``TOL``; the flash shapes and the forward products timed
      beside their bound, the CUDA-core kernel, the plain version and the
      library call;
  16l. "cp serve" (the two-rank spawn): ``launch.serve --model-mesh 2`` on
      full smollm-135m at ``TP_SERVE_ARGV`` under context parallelism (9
      heads over 2): each prompt chunked, its 520 cache positions split
      260 a rank, decode combining the ranks' partial softmaxes; every
      sequence finished, 161,162,496 param bytes a rank, the ``kv`` bytes
      summed over the ranks "tp serve one rank"'s, each rank's resident
      K/V half of it, the share of tokens equal to it printed, phase 4's
      teacher-forced prefill and decode at 2 layers (the cache split as
      the driver splits it) held to phase 4's CPU side by
      ``E2E_REL_TOL``, the MLP's and vocab's bytes a decode step gathers
      over the model axis, the decode step and prefill wave;
  16m. "moe tp numerics" / "moe cp numerics" (the same spawn): phase 18's
      GSPMD step (granite at full width cut to 2 layers, ZeRO-3) on a (1,
      2) mesh under tensor parallelism (8 heads, 4 KV heads, 16 experts and
      25,600 vocab rows a rank) and under context parallelism forced
      (128 of 256 positions a rank, the experts still 16 a rank: partial
      outputs reduce-scattered along the sequence), the params and masters
      joined over the ranks and the routing plans held against phase 18's
      kept CPU side by its bounds;
  16n. "moe tp train" (the same spawn): ``launch.train --engine pjit
      --model-mesh 2`` on granite at ``MOE_LAYERED_LAYERS`` layers,
      ``MOE_TRAIN_STEPS`` steps of 8 x 512: each rank's param bytes the
      rules', the losses "moe layered"'s by ``TRAIN_TOL``, the routing
      statistics equal on both ranks and one rank's (the expert load
      summing to 1, the dropped fraction "moe layered"'s), not twice them;
  16o. "moe tp serve" (the same spawn): ``launch.serve --model-mesh 2`` on
      full granite (24 layers) with phase 18's argv (``MOE_SERVE_ARGV``):
      1,339,232,256 param
      bytes a rank, the ``kv`` bytes summed over the ranks "moe serve"'s,
      every sequence finished, the share of tokens equal to its printed,
      the decode step's time;
  16p. the recurrent families on the model axis (the same spawn; held
      after phase 23, against its one-rank runs): "ssm cp numerics"
      (phase 20's mamba2, 2 layers at full width, 4 x 256, 2 steps, on a
      (1, 2) mesh under context parallelism: each rank 16 of the 32 SSD
      heads over the whole sequence, the chunks gathered, ``w_out``'s
      partials reduce-scattered, the gated norm's sum of squares summed
      over the ranks; held against phase 20's kept CPU side by its
      bounds), "ssm cp train" (``launch.train --model-mesh 2`` on full
      mamba2, 2 steps of 8 x 512: 382,546,944 param bytes a rank, the
      rules', "ssm plan train"'s losses by ``TRAIN_TOL``, the step wall),
      "ssm cp serve" (full mamba2 at phase 23's argv but 4 new tokens,
      ``SSM_SERVE_ARGV``: every sequence finished, the rules' param bytes
      a rank, each rank's parked caches its channels' and the whole
      ``conv_B`` / ``conv_C``, the ``kv`` summed and per rank and the
      share of tokens equal to "ssm serve"'s printed); mamba2's parts
      launch fused Adam alone, no flash and no tiled matmul; "hybrid tp
      train" (``launch.train --model-mesh 2`` on recurrentgemma at
      ``HYBRID_TRAIN_LAYERS``, 2 steps of 1 x 4096, tensor parallelism: 8
      heads, 2048 LRU channels, 6144 MLP columns and half the vocab a rank,
      the gate products reading the gathered channels; the rules' bytes a
      rank, "hybrid plan train"'s losses by ``TRAIN_TOL``, every flash
      launch windowed) and "hybrid tp serve" (full recurrentgemma, 38
      layers, phase 21's prompt, 3 sequences through 2 slots, 4 new
      tokens, ``HYBRID_SERVE_ARGV``: the rules' param bytes a rank, the
      window rings whole on each rank, checked as "ssm cp serve" against
      a one-rank run of the argv, "hybrid tp serve one rank");
  16q. the encoder-decoder on the model axis (the same spawn; held after
      phase 27, against its one-rank runs): "encdec tp numerics" / "encdec
      cp numerics" (phase 25's seamless, 2 + 2 layers at full width, 2 x
      256 frames, 64 decoder tokens, on a (1, 2) mesh under tensor
      parallelism, 8 of 16 heads a rank, the memory entering the model
      axis once, and under context parallelism forced, each rank its
      chunk of the frames and of the tokens, the encoder's and the
      cross-attention's keys gathered uncut; held against phase 25's kept
      CPU side by its bounds), "encdec tp train" (``launch.train
      --model-mesh 2`` on full seamless, 2 steps of 8 x 2048 frames: the
      rules' 617,070,592 param bytes a rank, "encdec plan train"'s losses
      by ``TRAIN_TOL``), "encdec tp serve" (full seamless, 3 sequences of
      2048 frames through 2 slots, 4 new tokens, ``ENCDEC_TP_SERVE_ARGV``:
      checked as "moe tp serve" against a one-rank run of the argv, "encdec
      tp serve one rank", each rank parking and fetching its KV heads of
      the third sequence's decoder K/V and ``xk`` / ``xv``, half the one
      rank's) and "encdec cp serve" (seamless at full width cut to 4 + 4
      layers, ``ENCDEC_CP_SERVE_CUT``, 2 sequences of 2048 frames, 4 new
      tokens, context parallelism forced: each rank's resident cache its
      258 of the 516 decoder positions and 1024 of the 2048 memory
      positions, half a one-rank run's of the same cut, "encdec cp serve
      one rank"); flash forward and backward and the tiled matmul at
      "encdec tp train"'s shapes are 16k's;
  16r. the ranks' slow-tier state (the same spawn; held after the
      encoder-decoder's phases): "gspmd nvme dp2 train" (``launch.train
      --engine pjit --data-mesh 2`` on full smollm with every state class
      on NVMe, params through the leaf scheduler, ``NVME_TRAIN_STEPS`` (2)
      steps of 8 x 512: each rank reads and writes its shards' bytes once
      a step, half of one rank's, the peak resident below the total,
      phase 12's losses by ``TRAIN_TOL``), "gspmd nvme q8 dp2 train" (the
      same with ``--param-quant q8``: each step's wire bytes the shards' q8
      frames, ``qformat.wire_nbytes``; the losses within ``q8_loss_bound``
      of the bf16 run's), "cp nvme train" (``--model-mesh 2``, context
      parallelism, params on NVMe, the in-graph update: ``TP_BYTES[2]``
      param bytes a rank each way a step, phase 12's losses) and "ckpt dp2
      drill" (16d's argv, ``DP_TRAIN_STEPS`` steps, a checkpoint every 2,
      a failure at step ``DRILL_FAIL_AT`` on both ranks, ``--resume auto``:
      one restart a rank, 16d's losses bit for bit, rank 0's checkpoint
      the bytes one rank's checkpoint of the state holds, its snapshot,
      persist and restore times); then, on one rank, "ckpt reshard" (the
      drill's step-2 checkpoint, one step, within ``TRAIN_TOL`` of the
      ranks' step 2) and "ckpt zero3 reshard" (16b's layered run's last
      checkpoint, one step of the layered epoch); every flash and tiled
      launch on the tensor cores;
  17. the restart drill: the in-graph run with a checkpoint every 2 steps
      and a failure injected at step 3 (``REPRO_FAIL_AT_STEP``), resumed
      with ``--resume auto``: one restart, the redone steps' losses equal
      to an uninterrupted run's bit for bit; then the layered NVMe epoch
      resumes from its last checkpoint and trains one step; the
      checkpoint's bytes, snapshot, persist and restore times printed;
  18. the MoE family (granite-moe-1b-a400m: 32 experts, top-8): one
      full-width layer's loss and gradients twice on the card, equal bits
      (``moe repeat``); the GSPMD step all on the device and the layered
      epoch on NVMe at 2 layers, full width, card against CPU by phase 11's
      bounds (``moe numerics``); full granite (24 layers) served at the
      serve host cell's sizes but 8 new tokens (``moe serve``,
      ``MOE_SERVE_ARGV``) and trained 4 steps under
      ``--plan auto`` (``moe plan train``: all on the device); the layered
      epoch at full width cut to ``MOE_LAYERED_LAYERS`` (4) layers,
      ``MOE_TRAIN_STEPS`` (2) steps,
      its router-selected expert rows paged from NVMe with 0 < peak
      resident expert bytes < all expert bytes (``moe layered``); its flash
      forward and backward shapes are checked in phase 7 (``FLASH_MOE``);
  19. flash attention with a local window (``window`` > 0: query i sees
      key j only if j > i + (Sk - Sq) - window), forward and backward
      against the windowed plain version by ``TOL``, bf16 and f32, at
      recurrentgemma-9b's heads over 4096 tokens with its window of 2048
      (head_dim 256) and at (8,9,3,1024,64) with a window of 256, both on
      the tensor cores and timed in bf16 beside their bound (the pairs the
      window keeps), the CUDA-core kernels, the plain version and SDPA
      with the window as a boolean mask, and at 2500 tokens past a window
      of 2048 at both head_dims (``FLASH_WINDOW``, ``FLASH_WINDOW_RAGGED``);
  20. recurrent numerics: the GSPMD step all on the device, card against
      CPU by phase 11's bounds, on mamba2-370m at full width cut to 2
      layers (4 x 256 tokens) and recurrentgemma-9b at full width cut to 3
      layers (one group, 1,705,070,592 params; 1 x 128 tokens, one step:
      its CPU side is the run's slowest, and runs beside the card's phases
      from phase 2 on);
  21. hybrid serve: full recurrentgemma-9b (38 layers, 9,396,301,824
      params on the device), 8 sequences through 4 slots, prompt 2560 (past
      the window: the K/V rings roll at prefill and wrap), 16 new tokens,
      waiting caches parked whole on the host tier; decode and prefill
      tokens/s and TTFT p50/p99;
  22. hybrid plan train: ``--plan auto`` on recurrentgemma-9b at full width
      cut to ``HYBRID_TRAIN_LAYERS`` (5: one group and the two-block tail,
      2,174,906,368 params), 4 steps of 1 x 4096 tokens (past the window,
      so the windowed backward runs), loss falling;
  23. ssm serve / ssm plan train: full mamba2-370m (48 layers, 369,169,920
      params) served at the serve host cell's sizes (8 sequences, 4 slots,
      prompt 512, 32 new tokens) and trained 4 steps of 8 x 512 tokens
      under ``--plan auto``;
  24. the VLM's and the encoder-decoder's kernel shapes
      (``phase_family_kernels``): flash forward and backward at llava's
      training shape (1 x 4096, 56 query heads on 8 KV heads of 128,
      causal) and at seamless's encoder (8 x 2048 frames, 16 heads of 64,
      not causal), cross-attention (512 decoder queries on 2048 frames,
      not causal) and decoder self-attention (512, causal); the tiled
      matmul at llava's swiglu, (4096,7168)@(7168,20480) and
      (4096,20480)@(20480,7168), with dX and dW on transposed views, and at
      seamless's gelu, (16384,1024)@(1024,4096) and back; bf16 by ``TOL``,
      timed beside bound, plain, CUDA-core kernel and SDPA / torch.matmul;
  25. family numerics: the GSPMD step all on the device, card against CPU
      by phase 11's bounds, on seamless-m4t-medium at full width cut to 2 +
      2 layers (2 x 256 frames, 64 decoder tokens) and on llava-next-34b
      at full width cut to one layer and 96 vision positions
      (``VLM_NUMERICS_CUT``: a layer at its 2880 positions costs the CPU
      ~27 TFLOP a step), 1 x 160 positions, one step (each CPU side from
      the thread of phase 2); each numerics phase compares on the card and
      prints its sides' seconds (``... compare:`` lines);
  26. vlm serve / vlm plan train: llava-next-34b at full width cut to 8
      layers (5.40 B params) served, 8 sequences through 4 slots, prompt
      3072 (2880 vision positions, 192 tokens), 16 new tokens, waiting K/V
      paged on the host tier; cut to 2 layers (2.06 B params), 4 steps of
      1 x 4096 (2880 vision positions, 1216 tokens) under ``--plan auto``:
      flash backward at n_rep 7;
  27. encdec serve / encdec plan train: full seamless-m4t-medium (12 + 12
      layers, 0.62 B params) served, 8 sequences through 4 slots, 2048
      frames (512 decoder tokens), 32 new tokens, waiting decoder K/V paged
      and cross-attention K/V parked whole; 4 steps of 8 x 2048 frames
      under ``--plan auto``: flash launched by the encoder, the decoder and
      the cross-attention in every step;
  28. the params on NVMe (the GSPMD leaf scheduler) and the activation
      checkpoint policies, on seamless-m4t-medium: "gspmd numerics" in
      ``NVME_PLACEMENTS`` (params on NVMe with the in-graph fused Adam;
      every state class on NVMe under ``remat="dots"``), card against
      phase 25's CPU run of seamless (the same weights and batches, all on
      the device) at ``ENCDEC_NUMERICS_CUT`` by phase 11's bounds; "encdec
      plan nvme":
      full seamless, 2 steps of 8 x 2048 frames (~17 s each) under
      ``--plan auto --objective min_device_mem``, which the planner
      answers with the GSPMD engine and every state class on NVMe: each
      step's param bytes
      in and out equal the leaves' bytes, the gradients drained are the
      f32 leaves' bytes, the optimizer moves what the plan predicts, the
      residency flag holds, no fused Adam (the host Adam updates), the
      device's busy share of the steps from a CUDA-only profile;
      "encdec remat": full seamless all on the device, 3 steps of 8 x 2048
      under ``none``, ``full`` and ``dots``: the first loss agrees, the
      peak allocated memory is ordered none > dots > full, and ``dots``
      launches the tiled matmul as ``none`` does and the flash forward as
      ``full`` does;
  29. each phase's seconds (a ``phase <name>: s`` line after each, and a
      ``phases:`` line of all of them), the kernels JSON line, then the
      device JSON line last.

In every main path (5, 6, 9, 10, 12, 13, 14, 16, 16a-16r (each rank), 17,
18, 21, 22, 23, 26, 27, 28) each flash-attention launch, forward and backward (the recompute under
``remat="full"`` included), each tiled-matmul launch and each
quantized-matmul launch, forward and dX, must be on the tensor-core route
(``*_wgmma``), none on ``simt``: the hybrid paths' flash launches too
(head_dim 256), exactly one per attention layer (forward, its recompute,
backward) and each with the window; mamba2's paths launch no flash and no
tiled matmul (its products are the reference's einsums outside Pallas).
``plan_residency_ok`` must be true wherever a step reports it.

Needs no network and exactly one card; exits non-zero without CUDA.
``chip_smoke.py --dp-rank all|tp3|<part>[,<part>...]`` (parts of ``DP_PARTS`` or
``TP3_PARTS``) is one rank of phase 16a-16r, started by the script itself through
``torch.distributed.run``; ``chip_smoke.py --nccl-check [train|serve|tp]``
runs phase 16b's and 16d's paths ("train"), llava served on the ranks
("serve": at 8 layers against one rank's tokens, then at full depth, a
quarter of its params a rank) and llava under tensor parallelism ("tp":
trained at 2 layers, served at full depth with ``--model-mesh 4``) on
four ranks with a card each (NCCL), on a machine with four cards.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.config import (RunConfig, ShapeConfig, TrainConfig,  # noqa: E402
                                make_offload, make_parallel)
from repro_torch.core import kvcache, qformat  # noqa: E402
from repro_torch.core import partition as pt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.engine import ZeroInfinityEngine  # noqa: E402
from repro_torch.core.executor import InfinityExecutor, keystr  # noqa: E402
from repro_torch.core.zero import ExplicitZero3Engine  # noqa: E402
from repro_torch.data.pipeline import SyntheticStream, rank_batch, rank_slice  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import quantized_matmul as tqm  # noqa: E402
from repro_torch.kernels import tiled_matmul as tmm  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.runtime.metrics import device_ms as time_ms  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no sparsity
SEED = 0

# serve shapes of full smollm-135m at --kv-slots 4 --prompt-len 512
FLASH_SERVE = (4, 9, 3, 512, 512, 64)  # B, H, KV, Sq, Sk, D
TILED_SERVE = [(2048, 576, 1536), (2048, 1536, 576), (4, 576, 1536)]  # M, K, N
FLASH_RAGGED = (1, 6, 2, 100, 132, 64)  # Sq < Sk, not a multiple of the tiles
# Sq = Sk, 77 rows a head: a head's lse rows start off 16-byte boundaries
FLASH_ODD = (2, 3, 1, 77, 77, 64)
TILED_RAGGED = (300, 200, 100)  # w's rows 200 bytes apart: TMA cannot read it
# Each element must satisfy |kernel - plain| <= rtol*|plain| + mtol*mag + atol,
# where mag is the plain version on absolute values (softmax weights on |v|,
# |x| @ |w|): the size that rounding errors inside the sums scale with.
# f32: sums differ only in order, so an absolute 1e-4 at outputs of O(1).
# bf16: the two outputs may round one ulp apart (<= 2^-7 |out|); attention
# also rounds p to bf16 against the running max in the kernel and against
# the row's total in the plain version, <= 2^-8 relative each, so 2^-7 of
# sum p|v|; the matmul's f32 sums in another order stay under K*2^-24 of
# |x| @ |w| (2^-13 at K <= 1536, taken as 2^-12).
TOL = {("flash_attention", torch.bfloat16): {"rtol": 2**-7, "mtol": 2**-7, "atol": 0.0},
       ("tiled_matmul", torch.bfloat16): {"rtol": 2**-7, "mtol": 2**-12, "atol": 0.0},
       ("flash_attention", torch.float32): {"rtol": 0.0, "mtol": 0.0, "atol": 1e-4},
       ("tiled_matmul", torch.float32): {"rtol": 0.0, "mtol": 0.0, "atol": 1e-4}}
E2E_REL_TOL = 5e-2  # 2 bf16 layers, CPU vs card rounding, relative to max |logit|

# training shapes of full smollm-135m at --batch 8 --seq 512 (4096 tokens)
FLASH_TRAIN = (8, 9, 3, 512, 512, 64)
# the MLP's products per layer: (M, K, N, which operand is a transposed view)
# forward x@W_in|gate and h@W_out, then per projection dX = dY @ W^T and
# dW = X^T @ dY, read in place
TILED_TRAIN = [(4096, 576, 1536, ""), (4096, 1536, 576, ""),
               (4096, 1536, 576, "w"), (576, 4096, 1536, "x"),
               (4096, 576, 1536, "w"), (1536, 4096, 576, "x")]
TILED_TRAIN_RAGGED = [(300, 200, 100, "x"), (300, 200, 100, "w")]
# the tensor-core route at the fourth major-ness (x M-major, w K-major, which
# no main path hands it) at K = 4096, and at a shape that is a multiple of
# no tile (ragged M, N and K), plain and with each operand transposed
TILED_WGMMA = [(1536, 4096, 576, "xw")] + [(296, 200, 104, t) for t in ("", "x", "w", "xw")]
# the tensor-core kernels (tiled matmul, flash forward and backward) must
# beat the CUDA-core ones by this at every timed bf16 training and prefill
# shape (not the tiled matmul at decode, M = 4)
WGMMA_MIN_SPEEDUP = 4.0
ADAM_SIZES = [(49152 * 576, "embed.tok"), (576, "ln_f.scale"), (100_001, "ragged")]
# the quantized matmul on q8 weights q (K, N): (M, K, N, dX orientation);
# forward x (M,K) @ W_in|gate (576,1536) and h (M,1536) @ W_out (1536,576),
# dX = dY (M,1536) @ W_in|gate^T and dY (M,576) @ W_out^T
QMM_TRAIN = [(4096, 576, 1536, False), (4096, 1536, 576, False),
             (4096, 576, 1536, True), (4096, 1536, 576, True)]
QMM_RAGGED = [(100, 96, 64, False), (100, 96, 64, True)]
# flash at the heads of the dense configs with the widest heads, on the
# tensor cores (dQ blocks of 64 query rows, dK/dV blocks on slabs of
# head_dim): gemma-7b (16 heads, head_dim 256) and nemotron-4-340b (96
# query heads over 8 KV heads, head_dim 192)
FLASH_WIDE = [(1, 16, 16, 512, 512, 256), (1, 96, 8, 256, 256, 192)]
# the MoE family's training shape: full granite-moe-1b-a400m at --batch 8
# --seq 512 (16 query heads over 8 KV heads, head_dim 64: the tensor cores)
MOE_ARCH = "granite-moe-1b-a400m"
FLASH_MOE = (8, 16, 8, 512, 512, 64)
# flash with a local window, (shape, window), all on the tensor cores:
# recurrentgemma-9b's attention (16 query heads over one KV head, head_dim
# 256) at the hybrid training cell's 4096 tokens with its window of 2048,
# smollm-width heads over 1024 tokens with a window of 256, and ragged
# lengths past the window at both head_dims (untimed)
FLASH_WINDOW = [((1, 16, 1, 4096, 4096, 256), 2048), ((8, 9, 3, 1024, 1024, 64), 256)]
FLASH_WINDOW_RAGGED = [((1, 16, 1, 2500, 2500, 256), 2048), ((2, 4, 2, 2500, 2500, 64), 2048)]
# the fixed-state families: recurrentgemma-9b (hybrid: RG-LRU blocks and
# local attention, head_dim 256) and mamba2-370m (ssm: chunked SSD, no
# attention and no MLP); the hybrid trains at full width cut to one group
# and the two-block tail
HYBRID_ARCH = "recurrentgemma-9b"
SSM_ARCH = "mamba2-370m"
HYBRID_TRAIN_LAYERS = 5
# The flash backward's bf16 gradients: one output ulp (2^-7 |plain|) plus,
# inside dV, the rare p rounded to bf16 one ulp apart in kernel and plain
# version (lse and the f32 scores differ in the last bits): 2^-9 of the
# gradient's largest element (mag = max |plain|). f32: sums of <= 512
# products in another order, 1e-4 of the largest element. The matmul's bf16
# bound is K * 2^-24 of |x| @ |w|, taken as 2^-11 at K = 4096. Fused Adam
# repeats the plain version's f32 operations in order with no FMA
# contraction, so it must agree bit for bit.
TOL.update({
    ("flash_attention_bwd", torch.bfloat16): {"rtol": 2**-7, "mtol": 2**-9, "atol": 0.0},
    ("flash_attention_bwd", torch.float32): {"rtol": 0.0, "mtol": 1e-4, "atol": 0.0},
    ("tiled_matmul_k4096", torch.bfloat16): {"rtol": 2**-7, "mtol": 2**-11, "atol": 0.0},
    ("tiled_matmul_k4096", torch.float32): {"rtol": 0.0, "mtol": 0.0, "atol": 1e-4},
    ("fused_adam", torch.float32): {"rtol": 0.0, "mtol": 0.0, "atol": 0.0},
    ("fused_adam", torch.bfloat16): {"rtol": 0.0, "mtol": 0.0, "atol": 0.0},
})
# The quantized matmul: both versions dequantize each weight element by the
# same single f32 product q * s, so they differ as the tiled matmul's do —
# one output ulp in bf16 and f32 sums of <= 1536 terms in another order
# (K * 2^-24 of |x| @ |W|, taken as 2^-12); f32: 1e-4 at outputs of O(1).
TOL.update({
    ("quantized_matmul", torch.bfloat16): {"rtol": 2**-7, "mtol": 2**-12, "atol": 0.0},
    ("quantized_matmul", torch.float32): {"rtol": 0.0, "mtol": 0.0, "atol": 1e-4},
})
# Training numerics, card vs CPU: the per-step loss and grad norm by the
# reference's cross-tier tolerance (rtol = atol = 2e-3; bf16 activations
# rounded at other places, averaged down in a mean and a norm). Rows after
# the last step: AdamW's normalized update is bounded whatever the
# gradient, so the two runs' f32 masters differ by at most
# ``adam.parity_bound`` (~2 * sum(lr): a tiny gradient may flip sign
# between them), held as it is on the masters read back from the optimizer
# store; the stored bf16 rows add each side's rounding, at most half an ulp
# of each (<= 2^-8 of its value); in the bulk, gradients rounded to bf16
# apart (2^-8) move Adam's ratio by a few 2^-8 of lr: mean |diff| <= 2^-5 *
# sum(lr).
# With q8 rows each side re-encodes its updated rows: a value may land one
# quant step (its block's absmax/127) from the other side's, so each
# element's bound adds two steps; the mean bound holds as it is (the flips
# average to the values' own drift; measured on the CPU against the
# reference at 0.27 of it).
TRAIN_TOL = {"rtol": 2e-3, "atol": 2e-3}
# the GSPMD step's placements held card vs CPU (phase 11): (param, grad,
# opt tier, remat); the params and masters by the bounds above. The first
# three run on smollm; the params on NVMe through the leaf scheduler
# (in-graph fused Adam, and every state class on NVMe under remat="dots")
# run on seamless (phase 28)
GSPMD_PLACEMENTS = {"in_graph": ("device", "device", "device", "none"),
                    "off_graph": ("device", "device", "nvme", "full"),
                    "host": ("host", "device", "host", "full"),
                    "param_nvme": ("nvme", "device", "device", "none"),
                    "all_nvme_dots": ("nvme", "nvme", "nvme", "dots")}
SMOLLM_PLACEMENTS = ("in_graph", "off_graph", "host")
NVME_PLACEMENTS = ("param_nvme", "all_nvme_dots")
# the explicit engine's monolithic step held card vs CPU (phase 15): (param,
# grad, opt tier, int8 compression); the flat and masters by the bounds
# above. Under int8 the 'other' gradients cross a 127-level quantizer: an
# element the two sides round a bf16 ulp apart may land one level (1/127
# of its block's absmax) apart, and the carried residual adds at most half
# a level more, so the grad norm takes rtol 2^-6 (~2/127) instead.
ZERO3_PLACEMENTS = {"in_graph": ("device", "device", "device", "none"),
                    "host": ("host", "device", "host", "none"),
                    "off_graph_nvme": ("device", "device", "nvme", "none"),
                    "int8": ("device", "device", "device", "int8")}
INT8_NORM_TOL = {"rtol": 2**-6, "atol": 2e-3}
# the VLM and the encoder-decoder: llava-next-34b at full width (d_model
# 7168, 56 query heads on 8 KV heads of 128, swiglu d_ff 20480, vocab 64000
# padded to 65536; 60 layers do not fit one card: served cut to 8, trained
# cut to 2) and full seamless-m4t-medium (12 + 12 layers, d_model 1024, 16
# heads of 64, gelu d_ff 4096, tied vocab 256206 padded to 258048)
VLM_ARCH = "llava-next-34b"
ENCDEC_ARCH = "seamless-m4t-medium"
VLM_SERVE_LAYERS = 8
VLM_TRAIN_LAYERS = 2
# their flash operating points, (shape, causal): llava's training shape (1 x
# 4096: 2880 vision positions and 1216 tokens, n_rep 7); seamless's at 8 x
# 2048 frames: the encoder (Sq = Sk), the cross-attention (512 decoder
# tokens on 2048 frames) and the decoder's causal self-attention
FLASH_VLM_ENCDEC = [((1, 56, 8, 4096, 4096, 128), True), ((8, 16, 16, 2048, 2048, 64), False),
                  ((8, 16, 16, 512, 2048, 64), False), ((8, 16, 16, 512, 512, 64), True)]
# their MLP products: llava's x @ W_in|gate and h @ W_out at 4096 tokens
# (timed), dX = dY @ W_in^T and dW = X^T @ dY on transposed views;
# seamless's at 16384 frames (timed)
TILED_VLM_ENCDEC = [(4096, 7168, 20480, ""), (4096, 20480, 7168, ""),
                         (4096, 20480, 7168, "w"), (7168, 4096, 20480, "x"),
                         (16384, 1024, 4096, ""), (16384, 4096, 1024, "")]
# f32 sums of K products in another order: K * 2^-24 of |x| @ |w|, 2^-9.7 at
# llava's K = 20480 (its down projection and dX), taken as 2^-9
TOL.update({
    ("tiled_matmul_k20480", torch.bfloat16): {"rtol": 2**-7, "mtol": 2**-9, "atol": 0.0},
})
# the VLM's card-vs-CPU numerics: one full-width llava layer's CPU step at
# its 2880 vision positions is ~27 TFLOP, so the CPU side runs one layer at
# full width over 96 vision positions and 64 tokens (its vocab and widths
# as they are), and seamless at full width, 2 + 2 layers
VLM_NUMERICS_CUT = {"n_layers": 1, "vision_len": 96}
ENCDEC_NUMERICS_CUT = {"n_layers": 4, "n_enc_layers": 2, "n_dec_layers": 2}
# --hw-device-mem for phase 13: usable HBM (70 %) below the 2.57 GB of full
# smollm-135m's states and checkpoints at 8 x 512 tokens, above its 0.95 GB
# without the optimizer: the planner moves the optimizer off the device
# (to NVMe: the in-graph host stream would transit 1.61 GB) and keeps params
OFFLOAD_DEVICE_MEM = "3e9"


def say(*a) -> None:
    print(*a, flush=True)


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def randn(shape, dtype, gen, scale):
    return (torch.randn(shape, device="cuda", generator=gen) * scale).to(dtype)


def compare(name, shape, dtype, out, plain, mag) -> dict:
    """Hold a kernel's output against its plain version by ``TOL``; raise
    on any element outside it or any non-finite value."""
    tol = TOL[(name, dtype)]
    err = (out.float() - plain.float()).abs()
    allowed = tol["rtol"] * plain.float().abs() + tol["mtol"] * mag.float() + tol["atol"]
    # an exact tolerance (allowed 0) admits only err 0
    worst = torch.where(err == 0, 0.0, err / allowed).max().item()
    rec = {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
           "max_abs_err": err.max().item(), "tol": tol, "worst_err_over_tol": worst}
    if not worst <= 1.0 or not torch.isfinite(out).all():
        raise SystemExit(f"FAIL {name} {shape} {dtype}: an element is "
                         f"{worst:.3g}x its tolerance {tol} (max abs err "
                         f"{rec['max_abs_err']})")
    return rec


def causal_pairs(Sq: int, Sk: int, window: int = 0, causal: bool = True) -> int:
    """(query, key) pairs a head keeps: causal, query i sees keys
    j <= i + (Sk - Sq) and, under a window, j > i + (Sk - Sq) - window;
    not causal, every pair."""
    if not causal:
        return Sq * Sk
    off = Sk - Sq
    return sum(min(Sk, i + off + 1) - (max(0, i + off - window + 1) if window else 0)
               for i in range(Sq))


def sdpa(q, k, v, window: int = 0, causal: bool = True):
    """The library's attention on the same inputs: causal (or not), or
    under a window, or causal with fewer queries than keys (its
    ``is_causal`` aligns the mask at the start, the kernel's at the end),
    the plain version's boolean mask."""
    if not window and (not causal or q.shape[2] == k.shape[2]):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
    mask = ref.visible(q.shape[2], k.shape[2], causal, window, q.device)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def check_flash(shape, dtype, gen, timed: bool, window: int = 0,
                name: str = "flash_attention", causal: bool = True) -> dict:
    B, H, KV, Sq, Sk, D = shape
    # unit-variance q and k give scores of unit variance (peaked softmax) and
    # outputs of O(1); (B,S,H,D) storage passed as strided (B,H,S,D) views,
    # as the model's attention_block does
    q = randn((B, Sq, H, D), dtype, gen, 1.0).transpose(1, 2)
    k = randn((B, Sk, KV, D), dtype, gen, 1.0).transpose(1, 2)
    v = randn((B, Sk, KV, D), dtype, gen, 1.0).transpose(1, 2)
    out, rec_route = routed_flash(
        lambda: ops.flash_attention(q, k, v, causal=causal, window=window), (q, k, v),
        window=window, causal=causal)
    plain = ref.attention_ref(q, k, v, causal=causal, window=window)
    mag = ref.attention_ref(q, k, v.abs(), causal=causal, window=window)
    torch.cuda.synchronize()
    rec = compare("flash_attention", shape, dtype, out, plain, mag)
    rec.update(rec_route)
    if window:
        rec["window"] = window
    rec["causal"] = causal
    if timed:
        # the pairs the mask keeps: the work this run does
        pairs = causal_pairs(Sq, Sk, window, causal) * B * H
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4.0 * D * pairs, dtype)
        rec["ms"] = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal, window=window))
        rec["call_ms"] = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                             window=window), queued=False)
        rec["simt_ms"] = time_ms(lambda: tfa.flash_attention_cuda(q, k, v, causal=causal,
                                                                   window=window, simt=True))
        rec["plain_ms"] = time_ms(lambda: ref.attention_ref(q, k, v, causal=causal,
                                                            window=window))
        rec["library_ms"] = time_ms(lambda: sdpa(q, k, v, window, causal))
        check_speedup(name, shape, rec)
    return rec


def routed(key: str, fn, want: str):
    """``fn()``, held by the launch counters of ``key`` to one launch on the
    route ``want`` (the one its module's ``route`` names), none on the
    other."""
    before = ops.launch_counts()
    out = fn()
    after = ops.launch_counts()
    took = [r for r in tmm.ROUTES if after[f"{key}_{r}"] == before[f"{key}_{r}"] + 1]
    if took != [want] or after[key] != before[key] + 1:
        raise SystemExit(f"FAIL {key}: launch counters {before} -> {after} for route {want}")
    return out


def routed_flash(fn, inputs, bwd: bool = False, window: int = 0, causal: bool = True) -> tuple:
    """A flash-attention call on the route ``flash_attention.route`` names
    for ``inputs`` (``routed``), and the plan of a tensor-core launch."""
    want = tfa.route(*inputs)
    out = routed("flash_attention_bwd" if bwd else "flash_attention", fn, want)
    rec = {"route": want}
    if want == "wgmma":
        (B, H, Sq, D), (_, KV, Sk, _) = inputs[0].shape, inputs[1].shape
        p = tfa.plan(B, H, KV, Sq, Sk, causal=causal, sms=torch.cuda.get_device_properties(0)
                     .multi_processor_count, window=window, D=D)
        rec["plan"] = {kern: {k: p[kern][k] for k in ("tile", "slab", "blocks", "blocks_per_sm")
                              if k in p[kern]}
                       for kern in (("dkdv", "dq") if bwd else ("fwd",))}
    return out, rec


def check_speedup(name, shape, rec) -> None:
    """A tensor-core launch must beat the CUDA-core kernel on the same
    inputs by ``WGMMA_MIN_SPEEDUP``."""
    if rec["route"] == "wgmma" and not rec["ms"] * WGMMA_MIN_SPEEDUP <= rec["simt_ms"]:
        raise SystemExit(f"FAIL {name} {shape}: wgmma {rec['ms']} ms is not "
                         f"{WGMMA_MIN_SPEEDUP}x faster than simt {rec['simt_ms']} ms")


def check_flash_routes(recs) -> None:
    """bf16 at head_dim 64, 128, 192 or 256 takes the tensor cores; f32 the
    CUDA cores."""
    for r in recs:
        bf16_wgmma = r["dtype"] == "bfloat16" and r["shape"][-1] in tfa.WGMMA_HEAD_DIMS
        want = "wgmma" if bf16_wgmma else "simt"
        if r["route"] != want:
            raise SystemExit(f"FAIL flash_attention {r['shape']} {r['dtype']}: took "
                             f"{r['route']}, want {want}")


def check_tiled(shape, dtype, gen, timed: bool) -> dict:
    M, K, N = shape
    x = randn((M, K), dtype, gen, 0.1)
    w = randn((K, N), dtype, gen, 0.1)
    out, rec_route = routed_matmul(x, w)
    plain = ref.matmul_ref(x, w)
    mag = ref.matmul_ref(x.abs(), w.abs())
    torch.cuda.synchronize()
    rec = compare("tiled_matmul", shape, dtype, out, plain, mag)
    rec.update(rec_route)
    if timed:
        time_tiled(rec, x, w)
    return rec


def routed_matmul(x, w) -> tuple:
    """``ops.tiled_matmul`` on the route ``tiled_matmul.route`` names
    (``routed``), and the plan of a tensor-core launch."""
    want = tmm.route(x, w)
    out = routed("tiled_matmul", lambda: ops.tiled_matmul(x, w), want)
    rec = {"route": want}
    if want == "wgmma":
        M, K = x.shape
        rec["plan"] = tmm.plan(M, w.shape[1], K, torch.cuda.get_device_properties(0)
                               .multi_processor_count)
    return out, rec


def time_tiled(rec, x, w) -> None:
    """Times of one product on its route (ms), on the CUDA-core kernel as the
    previous design (simt_ms), the plain version and ``torch.matmul``."""
    M, K = x.shape
    N = w.shape[1]
    nbytes = (M * K + K * N + M * N) * x.element_size()
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2.0 * M * N * K, x.dtype)
    rec["ms"] = time_ms(lambda: ops.tiled_matmul(x, w))
    rec["call_ms"] = time_ms(lambda: ops.tiled_matmul(x, w), queued=False)
    rec["simt_ms"] = time_ms(lambda: tmm.tiled_matmul_cuda(x, w, simt=True))
    rec["plain_ms"] = time_ms(lambda: ref.matmul_ref(x, w))
    rec["library_ms"] = time_ms(lambda: torch.matmul(x, w))
    if M > 4:
        check_speedup("tiled_matmul", (M, K, N), rec)


def check_routes(recs) -> None:
    """Every bf16 product of the serve and training shapes, the fourth
    major-ness and the TMA-readable ragged shape take the tensor cores; f32
    and the ragged (300,200,100) the CUDA cores."""
    for r in recs:
        shape = tuple(r["shape"])
        want = "simt" if r["dtype"] == "float32" or shape == TILED_RAGGED else "wgmma"
        if r.get("transposed") and shape == TILED_RAGGED:
            continue  # TILED_TRAIN_RAGGED: held only against the plain version
        if r["route"] != want:
            raise SystemExit(f"FAIL tiled_matmul {shape} {r['dtype']} "
                             f"{r.get('transposed', '')!r}: took {r['route']}, want {want}")


def phase_kernels() -> dict:
    """Every kernel at every serve shape and one ragged shape, in bf16 (the
    path's type; timed at the serve shapes) and in f32 (tight tolerance)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    flash = [check_flash(FLASH_SERVE, bf16, gen, timed=True)]
    flash += [check_flash(FLASH_SERVE, f32, gen, timed=False)]
    flash += [check_flash(s, dt, gen, timed=False) for s in (FLASH_RAGGED, FLASH_ODD)
              for dt in (bf16, f32)]
    tiled = [check_tiled(s, bf16, gen, timed=True) for s in TILED_SERVE]
    tiled += [check_tiled(s, f32, gen, timed=False) for s in TILED_SERVE]
    tiled += [check_tiled(TILED_RAGGED, dt, gen, timed=False) for dt in (bf16, f32)]
    check_routes(tiled)
    check_flash_routes(flash)
    for rec in flash + tiled:
        say("kernel check:", json.dumps(rec))
    return {"flash_attention": flash, "tiled_matmul": tiled}


def check_tiled_t(case, dtype, gen, timed: bool) -> dict:
    """One product with operands as transposed views (``trans`` holds "x"
    and/or "w"), as the gradient products read the saved tensors."""
    M, K, N, trans = case
    x = randn((K, M) if "x" in trans else (M, K), dtype, gen, 0.1)
    w = randn((N, K) if "w" in trans else (K, N), dtype, gen, 0.1)
    x = x.T if "x" in trans else x
    w = w.T if "w" in trans else w
    out, rec_route = routed_matmul(x, w)
    plain = ref.matmul_ref(x, w)
    mag = ref.matmul_ref(x.abs(), w.abs())
    torch.cuda.synchronize()
    name = ("tiled_matmul" if K <= 1536 else "tiled_matmul_k4096" if K <= 8192
            else "tiled_matmul_k20480")
    rec = compare(name, (M, K, N), dtype, out, plain, mag)
    rec["transposed"] = trans
    rec.update(rec_route)
    if timed:
        time_tiled(rec, x, w)
    return rec


def check_flash_bwd(shape, dtype, gen, timed: bool, window: int = 0,
                    name: str = "flash_attention_bwd", causal: bool = True) -> dict:
    """dq, dk, dv of the kernel against ``ref.attention_bwd_ref`` from the
    same saved o and lse (the kernel forward's), strided (B,S,H,D) views."""
    B, H, KV, Sq, Sk, D = shape
    q, do = (randn((B, Sq, H, D), dtype, gen, 1.0).transpose(1, 2) for _ in range(2))
    k, v = (randn((B, Sk, KV, D), dtype, gen, 1.0).transpose(1, 2) for _ in range(2))
    o, lse = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window, with_lse=True)

    def kernel(simt=False):
        return tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal, window=window,
                                            simt=simt)

    got, rec_route = routed_flash(kernel, (q, k, v, do), bwd=True, window=window,
                                  causal=causal)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    recs = [compare("flash_attention_bwd", shape, dtype, g, w, w.float().abs().max())
            for g, w in zip(got, want)]
    rec = {"shape": list(shape), "dtype": recs[0]["dtype"], "tol": recs[0]["tol"],
           "max_abs_err": max(r["max_abs_err"] for r in recs),
           "worst_err_over_tol": max(r["worst_err_over_tol"] for r in recs), **rec_route}
    if window:
        rec["window"] = window
    rec["causal"] = causal
    if timed:
        pairs = causal_pairs(Sq, Sk, window, causal) * B * H
        nbytes = ((3 * q.numel() + 4 * k.numel()) * q.element_size()  # q o dO dq; k v dk dv
                  + lse.numel() * 4)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 10.0 * D * pairs, dtype)
        rec["ms"] = time_ms(kernel)
        rec["call_ms"] = time_ms(kernel, queued=False)
        rec["simt_ms"] = time_ms(lambda: kernel(simt=True))
        rec["plain_ms"] = time_ms(lambda: ref.attention_bwd_ref(q, k, v, o, lse, do,
                                                                causal=causal, window=window))
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = sdpa(qg, kg, vg, window, causal)
        rec["library_ms"] = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True))
        check_speedup(name, shape, rec)
    return rec


def check_adam(n, label, gen, timed: bool) -> dict:
    """The kernel against the plain version on copies of the same state,
    all four outputs; timed at the embedding with the library's fused
    AdamW (``torch._fused_adamw_``, no bf16 copy) as the yardstick."""
    p, g, m = (randn((n,), torch.float32, gen, 1.0) for _ in range(3))
    v = randn((n,), torch.float32, gen, 0.01).abs()
    scal = ops.adam_scalars(3e-3, 0.9, 0.95, 1e-8, 0.1, 1 - 0.9, 1 - 0.95, "cuda")
    pr, mr, vr = p.clone(), m.clone(), v.clone()
    pbf = ops.fused_adam(p, g, m, v, scal)
    pad = (-n) % 128
    rows = lambda t: F.pad(t, (0, pad)).view(-1, 128)
    prr, mrr, vrr = rows(pr), rows(mr), rows(vr)
    pbf_ref = ref.adam_ref(prr, rows(g), mrr, vrr, scal).reshape(-1)[:n]
    torch.cuda.synchronize()
    recs = [compare("fused_adam", (n,), torch.float32, got, want.reshape(-1)[:n],
                    want.reshape(-1)[:n]) for got, want in ((p, prr), (m, mrr), (v, vrr))]
    recs.append(compare("fused_adam", (n,), torch.bfloat16, pbf, pbf_ref, pbf_ref))
    rec = {"shape": [-(-n // 128), 128], "elements": n, "leaf": label, "dtype": "float32",
           "tol": recs[0]["tol"], "max_abs_err": max(r["max_abs_err"] for r in recs),
           "worst_err_over_tol": max(r["worst_err_over_tol"] for r in recs)}
    if timed:
        rec["bound_ms"], rec["bound_by"] = bound(30.0 * n, 15.0 * n, torch.float32)
        rec["ms"] = time_ms(lambda: ops.fused_adam(p, g, m, v, scal))
        rec["plain_ms"] = time_ms(lambda: ref.adam_ref(prr, rows(g), mrr, vrr, scal))
        step = [torch.tensor(1.0, device="cuda")]
        rec["library_ms"] = time_ms(lambda: torch._fused_adamw_(
            [pr], [g], [mr], [vr], [], step, lr=3e-3, beta1=0.9, beta2=0.95,
            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False))
    return rec


def check_qmm(case, dtype, gen, timed: bool) -> dict:
    """The quantized matmul on the q8 operands of a random bf16 weight (the
    port's encoder), forward or in its dX orientation, against
    ``ref.quantized_matmul_ref``, on the route ``quantized_matmul.route``
    names (held by the launch counters). No single PyTorch call computes
    this function (library_ms null); ``torch.matmul`` on the weight already
    dequantized to bf16 is timed beside it as a labelled yardstick."""
    M, K, N, trans = case
    q, s, _ = qformat.wire_matmul_operands(
        qformat.encode_array(randn((K, N), torch.bfloat16, gen, 0.1), "q8"))
    q, s = q.cuda(), s.cuda()
    x = randn((M, N if trans else K), dtype, gen, 0.1)

    def call():
        return tqm.quantized_matmul_cuda(x, q, s, transpose=trans)

    want = tqm.route(x, q)
    out = routed("quantized_matmul_dx" if trans else "quantized_matmul", call, want)
    plain = ref.quantized_matmul_ref(x, q, s, transpose=trans)
    w_abs = qformat.dequant_q8(q, s).abs()
    mag = x.float().abs() @ (w_abs.T if trans else w_abs)
    torch.cuda.synchronize()
    rec = compare("quantized_matmul", (M, K, N), dtype, out, plain, mag)
    rec["transposed"] = trans
    rec["route"] = want
    n_out = K if trans else N
    if want == "wgmma":
        rec["plan"] = tqm.plan(M, n_out, torch.cuda.get_device_properties(0)
                               .multi_processor_count)
    if timed:
        nbytes = (x.numel() + M * n_out) * x.element_size() + q.numel() + s.numel() * 2
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2.0 * M * N * K, dtype)
        rec["ms"] = time_ms(call)
        rec["call_ms"] = time_ms(call, queued=False)
        rec["simt_ms"] = time_ms(lambda: tqm.quantized_matmul_cuda(x, q, s, transpose=trans,
                                                                   simt=True))
        rec["plain_ms"] = time_ms(lambda: ref.quantized_matmul_ref(x, q, s, transpose=trans))
        rec["library_ms"] = None
        w = qformat.dequant_q8(q, s).to(dtype)
        w = w.T if trans else w
        rec["yardstick"] = "torch.matmul on the weight dequantized to bf16"
        rec["yardstick_ms"] = time_ms(lambda: torch.matmul(x, w))
        check_speedup("quantized_matmul", (M, K, N), rec)
    return rec


def check_qmm_routes(recs) -> None:
    """bf16 at every training and ragged shape takes the tensor cores, f32
    the CUDA cores."""
    for r in recs:
        want = "simt" if r["dtype"] == "float32" else "wgmma"
        if r["route"] != want:
            raise SystemExit(f"FAIL quantized_matmul {r['shape']} {r['dtype']} "
                             f"transposed={r['transposed']}: took {r['route']}, want {want}")


def phase_train_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bf16, f32 = torch.bfloat16, torch.float32
    flat_n = zero3_flat_elems()
    adam = [check_adam(n, label, gen, timed=(i == 0)) for i, (n, label) in enumerate(ADAM_SIZES)]
    adam.append(check_adam(flat_n, "zero3 flat (L, P)", gen, timed=True))
    fwd = [check_flash(FLASH_TRAIN, bf16, gen, timed=True)]
    bwd = [check_flash_bwd(FLASH_TRAIN, bf16, gen, timed=True)]
    bwd += [check_flash_bwd(FLASH_TRAIN, f32, gen, timed=False)]
    bwd += [check_flash_bwd(s, dt, gen, timed=False) for s in (FLASH_RAGGED, FLASH_ODD)
            for dt in (bf16, f32)]
    fwd.append(check_flash(FLASH_MOE, bf16, gen, timed=True))
    bwd.append(check_flash_bwd(FLASH_MOE, bf16, gen, timed=True))
    for shape in FLASH_WIDE:
        fwd += [check_flash(shape, bf16, gen, timed=True), check_flash(shape, f32, gen, timed=False)]
        bwd += [check_flash_bwd(shape, bf16, gen, timed=True),
                check_flash_bwd(shape, f32, gen, timed=False)]
    check_flash_routes(fwd + bwd)
    tiled = [check_tiled_t(c, bf16, gen, timed=True) for c in TILED_TRAIN]
    tiled += [check_tiled_t(c, f32, gen, timed=False) for c in TILED_TRAIN]
    tiled += [check_tiled_t(c, dt, gen, timed=False) for c in TILED_TRAIN_RAGGED
              for dt in (bf16, f32)]
    tiled += [check_tiled_t(c, bf16, gen, timed=False) for c in TILED_WGMMA]
    check_routes(tiled)
    qmm = [check_qmm(c, bf16, gen, timed=True) for c in QMM_TRAIN]
    qmm += [check_qmm(c, f32, gen, timed=False) for c in QMM_TRAIN]
    qmm += [check_qmm(c, dt, gen, timed=False) for c in QMM_RAGGED for dt in (bf16, f32)]
    check_qmm_routes(qmm)
    for rec in adam + fwd + bwd + tiled + qmm:
        say("train kernel check:", json.dumps(rec))
    return {"fused_adam": adam, "flash_attention": fwd, "flash_attention_bwd": bwd,
            "tiled_matmul": tiled,
            "quantized_matmul": [r for r in qmm if not r["transposed"]],
            "quantized_matmul_dx": [r for r in qmm if r["transposed"]]}


def _train_run(cfg, dev, nvme_dir, steps, quant="none") -> RunConfig:
    shutil.rmtree(nvme_dir, ignore_errors=True)
    return RunConfig(
        model=cfg, parallel=make_parallel("zero3", remat="none"),
        offload=make_offload(opt_tier="nvme", param_tier="nvme", grad_tier="nvme",
                             nvme_dir=nvme_dir, param_quant=quant),
        train=TrainConfig(lr=3e-3, steps=steps, seed=SEED))


def _q8_step(rows: torch.Tensor) -> torch.Tensor:
    """Each element's q8 quant step: its block's scale (absmax / 127) as
    the q8 encoder stores it."""
    P = rows.shape[1]
    scales = torch.stack([qformat.q8_encode(r)[1] for r in rows])
    return scales.float().repeat_interleave(qformat.BLOCK, dim=1)[:, :P]


def _store_masters(ex) -> dict:
    """Every key's f32 Adam master, read back from the optimizer store."""
    off = ex.offload
    off.store.flush()  # the last step's write-back
    return {key: torch.cat([off.store.read(f"{key}.master.{ci}").result().reshape(-1)
                            for ci in range(-(-n // off.chunk))])
            for key, _, n in off.layout}


def _masters(ex) -> torch.Tensor:
    """The rank's (L, P/dp) f32 Adam masters of the rows, read back from
    the optimizer store."""
    flat = _store_masters(ex)
    return torch.stack([flat[f"{ex.rank_key}/l{li}"] for li in range(len(flat))]).float()


# the layered numerics phases' model and batches (full-width smollm-135m
# cut to 2 layers, B x S, steps), and their CPU sides kept by
# ``--param-quant`` for "zero3 dp2 numerics"' q8 case
TRAIN_NUMERICS = (2, 4, 256, 2)
LAYERED_CPU_RUNS: dict = {}


def phase_train_numerics(quant: str = "none") -> dict:
    """Full-width smollm-135m cut to 2 layers: 2 layered steps on the card
    (kernels) and on the CPU (plain versions), same weights and batches;
    ``quant`` is ``--param-quant``. The CPU side is kept in
    ``LAYERED_CPU_RUNS``."""
    layers, B, S, steps = TRAIN_NUMERICS
    cfg = dataclasses.replace(configs.get("smollm-135m"), n_layers=layers)
    base = os.path.join(ROOT, "build", f"chip_smoke_train_numerics_{quant}")
    state0 = None
    out = {}
    for dev in ("cpu", "cuda"):
        ex = InfinityExecutor(_train_run(cfg, dev, os.path.join(base, dev), steps, quant),
                              dev)
        if state0 is None:
            state0 = ex.engine.init_state(torch.Generator().manual_seed(SEED))
        state = ex.reseed(_to(state0, dev))
        stream = SyntheticStream(ex.input_specs(ShapeConfig("n", S, B, "train")),
                                 cfg.vocab_size, seed=SEED)
        step = ex.make_train_step()
        traj = []
        for i in range(steps):
            batch = {k: torch.from_numpy(a).to(dev) for k, a in stream.batch_at(i).items()}
            state, m = step(state, batch)
            traj.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        out[dev] = (traj, ex.materialize_flat().float(), _masters(ex))
        ex.close()
    LAYERED_CPU_RUNS[quant] = out["cpu"]
    rec = {"param_quant": quant, "layers": layers, "d_model": cfg.d_model, "batch": B,
           "seq": S, "steps": steps}
    return hold_rows_to_cpu("train numerics", quant, out["cpu"], out["cuda"], rec)


def hold_rows_to_cpu(tag: str, quant: str, cpu: tuple, card: tuple, rec: dict) -> dict:
    """``(trajectory, (L, P) rows, (L, P) f32 masters)`` of a layered card
    run against a CPU run of the same function: loss and grad norm by
    ``TRAIN_TOL``, the masters by the drift bound, the rows by it plus each
    side's bf16 rounding (under q8 two quant steps of the row's block:
    each side re-encodes its rows), their mean by 2^-5 * sum(lr). Prints
    ``rec`` with the numbers; fails the script beyond a bound."""
    (tc, rows_c, masters_c), (tg, rows_g, masters_g) = cpu, card
    lrs = [t["lr"] for t in tc]
    drift = adam.parity_bound(TrainConfig(), lrs)
    master_diff = (masters_g - masters_c).abs()
    diff = (rows_g - rows_c).abs()
    # each side's bf16 rounding of its master: half an ulp, <= 2^-8 |value|
    allowed = drift + 2**-8 * (rows_c.abs() + rows_g.abs())
    if quant == "q8":
        allowed = allowed + 2 * _q8_step(rows_c)
    rec = {**rec, "cpu": tc, "card": tg, "tol": TRAIN_TOL,
           "rows_max_abs_diff": diff.max().item(), "rows_mean_abs_diff": diff.mean().item(),
           "rows_worst_diff_over_bound": (diff / allowed).max().item(),
           "masters_max_abs_diff": master_diff.max().item(),
           "masters_worst_diff_over_drift": master_diff.max().item() / drift,
           "rows_max_bound": drift, "rows_mean_bound": 2**-5 * sum(lrs)}
    say(f"{tag}:", json.dumps(rec))
    for c, g in zip(tc, tg):
        for key in ("loss", "grad_norm"):
            if not abs(g[key] - c[key]) <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(c[key]):
                raise SystemExit(f"FAIL {tag} ({quant}): card {key} {g[key]} vs CPU {c[key]}")
    if not rec["masters_max_abs_diff"] <= drift or not bool((diff <= allowed).all()) \
            or not rec["rows_mean_abs_diff"] <= rec["rows_mean_bound"]:
        raise SystemExit(f"FAIL {tag} ({quant}): rows differ beyond the bound: {rec}")
    return rec


def phase_train_main(quant: str = "none") -> tuple:
    """The training main path through ``launch.train`` on full smollm-135m;
    ``quant`` is ``--param-quant`` (q8: the quantized-matmul path)."""
    L, steps = configs.get("smollm-135m").n_layers, 8
    nvme = os.path.join(ROOT, "build", f"chip_smoke_nvme_{quant}")
    shutil.rmtree(nvme, ignore_errors=True)
    argv = ["--arch", "smollm-135m", "--engine", "zero3", "--offload-param", "nvme",
            "--offload-grad", "nvme", "--offload-opt", "nvme", "--batch", "8",
            "--seq", "512", "--steps", str(steps), "--lr", "3e-3", "--nvme-dir", nvme,
            "--log-every", "1", "--param-quant", quant]
    tag = "train" if quant == "none" else f"train {quant}"
    trace.enable()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.train(train.build_argparser().parse_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    # host time encoding rows to q8 frames (the seed's rows and each step's
    # write-back), from the tracer's wire_encode spans
    encodes = [ev[6] - ev[5] for ev in trace.TRACER.events() if ev[0] == "wire_encode"]
    trace.disable()
    trace.clear()
    tiers = ("param_in", "param_out", "grad_out", "opt_read", "opt_write")
    for m in hist["metrics"]:
        w = max(m["trace_wall_s"], 1e-12)
        say(f"{tag} step:", json.dumps({
            "step": m["step"], "loss": m["loss"], "grad_norm": m["grad_norm"],
            "step_s": m["step_time"], "tokens_per_s": m["tokens_per_s"],
            "compute_frac": m["trace_compute_s"] / w, "io_wait_frac": m["trace_io_wait_s"] / w,
            "other_frac": m["trace_other_s"] / w,
            **{f"{t}_bytes": m[f"{t}_bytes"] for t in tiers},
            **{f"{t}_gbps": m[f"{t}_gbps"] for t in tiers},
            "peak_resident_param_bytes": m["peak_resident_param_bytes"],
            "prefetch_hit_rate": m["prefetch_hit_rate"],
            "param_in_wire_bytes": m["param_in_wire_bytes"],
            "param_out_wire_bytes": m["param_out_wire_bytes"]}))
    losses = hist["losses"]
    rec = {"argv": " ".join(argv), "wall_s": wall, "launches": launches,
           "first_loss": losses[0], "last_loss": losses[-1],
           "param_total_bytes": hist["metrics"][0]["param_total_bytes"],
           "quantized_leaves": ["/".join(p) for p in hist["quantized_leaves"]],
           "wire_encode_rows": len(encodes), "wire_encode_s": sum(encodes),
           "nvme": hist["nvme_stats"], "losses": losses,
           "step_bytes": {f"{t}_bytes": hist["metrics"][-1][f"{t}_bytes"] for t in tiers}}
    say(f"{tag}:", json.dumps(rec))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL {tag}: losses not finite or not falling: {losses}")
    for m in hist["metrics"]:
        if not all(m[f"{t}_bytes"] > 0 for t in tiers):
            raise SystemExit(f"FAIL {tag}: a tier moved no bytes at step {m['step']}")
        if not m["peak_resident_param_bytes"] < m["param_total_bytes"]:
            raise SystemExit(f"FAIL {tag}: every param row was resident at once")
        # q8: 34 wire bytes per 32 bf16 elements (64 bytes), plus a header
        if quant == "q8" and not m["param_in_wire_bytes"] <= 0.54 * m["param_in_bytes"]:
            raise SystemExit(f"FAIL {tag}: param rows crossed as {m['param_in_wire_bytes']} "
                             f"wire bytes for {m['param_in_bytes']} logical")
    # per step: flash forward in every layer's forward and again in its
    # recompute; one flash backward per layer; three MLP projections
    # forward, three in the recompute and two gradient products each (q8:
    # the projections and their dX on the quantized kernel, dW on the tiled
    # matmul); fused Adam once per 'other' leaf (embedding, final norm)
    want = {"flash_attention": 2 * L * steps, "flash_attention_bwd": L * steps,
            "fused_adam": 2 * steps}
    if quant == "q8":
        want.update(quantized_matmul=6 * L * steps, quantized_matmul_dx=3 * L * steps,
                    tiled_matmul=3 * L * steps)
        if rec["quantized_leaves"] != ["mlp/w_gate", "mlp/w_in", "mlp/w_out"]:
            raise SystemExit(f"FAIL {tag}: the q8 plan leaves MLP weights out: "
                             f"{rec['quantized_leaves']}")
    else:
        want["tiled_matmul"] = (3 + 3 + 6) * L * steps
    for name, n in want.items():
        if launches[name] < n:
            raise SystemExit(f"FAIL {tag}: {name} launched {launches[name]} < {n}")
    check_main_path_routes(tag, launches)
    return rec, launches


ROUTED = ("flash_attention", "flash_attention_bwd", "tiled_matmul", "quantized_matmul",
          "quantized_matmul_dx")


def check_main_path_routes(tag, launches) -> None:
    """Every flash-attention (forward and backward), tiled-matmul and
    quantized-matmul (forward and dX) launch of a main path is a
    tensor-core one."""
    for name in ROUTED:
        if launches[f"{name}_simt"] or launches[f"{name}_wgmma"] != launches[name]:
            raise SystemExit(f"FAIL {tag}: {name} launched {launches[name]} times, "
                             f"{launches[f'{name}_wgmma']} on wgmma and "
                             f"{launches[f'{name}_simt']} on simt; want all on wgmma")


def attention_layers(cfg) -> int:
    """The flash launches of one forward: every layer of a dense, VLM or
    MoE model, one per (rec, rec, attn) group of the hybrid, none in
    mamba2; an encoder-decoder's encoder layers and its decoder layers
    twice (self- and cross-attention)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // len(cfg.block_pattern)
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_dec_layers
    return 0 if cfg.family == "ssm" else cfg.n_layers


# families whose MLPs run the tiled matmul (the MoE's experts are batched
# einsums, as the reference's; mamba2 has no MLP)
MLP_FAMILIES = ("dense", "vlm", "hybrid", "encdec")


def mlp_products(cfg, decode: bool = False) -> int:
    """The tiled-matmul launches of one forward's MLPs (prefill or a
    training step; ``decode``: a decode step, which runs no encoder): two
    or, gated, three projections in every layer with an MLP."""
    per = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    if cfg.family == "encdec":
        return per * (cfg.n_dec_layers if decode else cfg.n_enc_layers + cfg.n_dec_layers)
    return per * cfg.n_layers


def check_window_launches(tag, launches, cfg) -> None:
    """A windowed model's flash launches all carry its window; no other
    model's does."""
    for name in ("flash_attention", "flash_attention_bwd"):
        want = launches[name] if cfg.window else 0
        if launches[f"{name}_window"] != want:
            raise SystemExit(f"FAIL {tag}: {launches[f'{name}_window']} windowed {name} "
                             f"launches of {launches[name]}; want {want}")


def phase_e2e(arch: str = "smollm-135m") -> dict:
    """Full-width ``arch`` cut to 2 layers: the card (kernels) against the
    CPU (plain versions) from the same weights, teacher-forced."""
    cfg = dataclasses.replace(configs.get(arch), n_layers=2)
    bundle = registry.build(cfg)
    params_cpu = bundle.init(torch.Generator().manual_seed(SEED), "cpu")
    params_gpu = _to(params_cpu, "cuda")
    rng = np.random.default_rng(SEED)
    B, S, n_dec = 2, 64, 4
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + n_dec),
                                         dtype=np.int32))
    out = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        t = toks.to(dev)
        lg, cache = bundle.prefill(params, {"tokens": t[:, :S]})
        cache = kvcache.grow_cache(cache, n_dec, cfg.family)
        cache["len"] = torch.full((B,), S, dtype=torch.int32, device=dev)
        lgs = [lg.float().cpu()]
        for i in range(n_dec):
            lg, cache = bundle.decode_step(params, cache,
                                           {"tokens": t[:, S + i:S + i + 1]})
            lgs.append(lg.float().cpu())
        out[dev] = torch.cat(lgs, dim=1)
    a, b = out["cpu"], out["cuda"]
    E2E_CPU["logits"] = a
    if not torch.isfinite(b).all() or a.shape != b.shape:
        raise SystemExit(f"FAIL e2e: card logits {tuple(b.shape)} not finite "
                         f"or not {tuple(a.shape)}")
    worst = (a - b).abs().max().item() / max(a.abs().max().item(), 1e-30)
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    rec = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model, "batch": B,
           "prompt": S, "decode_steps": n_dec, "max_rel_err": worst,
           "tol": E2E_REL_TOL, "argmax_agree": agree}
    say("e2e check:", json.dumps(rec))
    if worst > E2E_REL_TOL:
        raise SystemExit(f"FAIL e2e: card vs CPU logits rel err {worst} > "
                         f"{E2E_REL_TOL}")
    return rec


def _to(tree, dev):
    """A copy of a nested dict / tuple of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_to(v, dev) for v in tree))
    return tree.to(dev, copy=True)


def run_serve(argv, **config) -> tuple:
    """``launch.serve`` with ``argv`` in this process (``config``: its
    ``run_serve``'s ``cfg`` / ``attn_strategy``): the run, its launches
    and its seconds."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.run_serve(serve._parse(argv), **config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, ops.launch_counts(), wall


def summarize(tag, argv, out, launches, wall, arch="smollm-135m", cfg=None) -> dict:
    """A serving run's numbers and checks. Every sequence finishes, KV
    moves through the tier, flash attention runs in every attention layer
    of every prefill wave; a dense, VLM, hybrid or enc-dec model's MLP
    projections run the tiled matmul in every layer of every wave and
    decode step (a MoE model's experts are batched einsums, as the
    reference's). ``cfg`` is the served config (``arch``'s by default)."""
    cfg = cfg or configs.get(arch)
    n = len(out["generated"])
    t = out["timings"]
    dec_toks = sum(len(g) for g in out["generated"]) - n
    waves = -(-n // out["slots"])
    rec = {"run": tag, "argv": " ".join(argv), "wall_s": wall,
           "prefill_waves": waves, "decode_steps": out["steps"],
           "admissions": out["admissions"],
           "prefill_tok_s": n * int(argv[argv.index("--prompt-len") + 1])
           / max(t["prefill_s"], 1e-9),
           "decode_tok_s": dec_toks / max(t["decode_s"], 1e-9),
           "ttft_p50_s": out["latency"]["ttft"]["p50"],
           "ttft_p99_s": out["latency"]["ttft"]["p99"],
           "decode_token_p50_s": out["latency"]["decode_token"]["p50"],
           "kv_in_bytes": out["kv"]["in_bytes"],
           "kv_out_bytes": out["kv"]["out_bytes"],
           "kv_in_wire_bytes": out["kv"]["in_wire_bytes"],
           "kv_out_wire_bytes": out["kv"]["out_wire_bytes"], "launches": launches}
    say("serve:", json.dumps(rec))
    if not all(out["done"]):
        raise SystemExit(f"FAIL {tag}: not every sequence finished")
    if out["admissions"] <= 0:
        raise SystemExit(f"FAIL {tag}: no sequence was admitted from the KV tier")
    if out["kv"]["in_bytes"] <= 0 or out["kv"]["out_bytes"] <= 0:
        raise SystemExit(f"FAIL {tag}: no KV bytes moved through the tier")
    if "--kv-quant" in argv and not (0 < out["kv"]["out_wire_bytes"]
                                     <= 0.54 * out["kv"]["out_bytes"]):
        raise SystemExit(f"FAIL {tag}: q8 KV parked {out['kv']['out_wire_bytes']} wire "
                         f"bytes for {out['kv']['out_bytes']} logical")
    A = attention_layers(cfg)
    if launches["flash_attention"] < A * waves:
        raise SystemExit(f"FAIL {tag}: flash_attention launched "
                         f"{launches['flash_attention']} < {A} x {waves} waves")
    if cfg.family in ("hybrid", "ssm") and launches["flash_attention"] != A * (waves + 1):
        # exactly the attention layers of each wave and of the warm-up prefill
        raise SystemExit(f"FAIL {tag}: flash_attention launched "
                         f"{launches['flash_attention']} times; want {A} x ({waves} + 1)")
    want = mlp_products(cfg) * waves + mlp_products(cfg, decode=True) * out["steps"]
    if cfg.family in MLP_FAMILIES and launches["tiled_matmul"] < want:
        raise SystemExit(f"FAIL {tag}: tiled_matmul launched "
                         f"{launches['tiled_matmul']} < {want} ({waves} waves, "
                         f"{out['steps']} steps)")
    check_main_path_routes(tag, launches)
    check_window_launches(tag, launches, cfg)
    for g in out["generated"]:
        if any(not 0 <= tok < cfg.padded_vocab() for tok in g):
            raise SystemExit(f"FAIL {tag}: token outside the padded vocab: {g}")
    return rec


def _gspmd_run(cfg, nvme_dir, steps, placement) -> RunConfig:
    param, grad, opt, remat = GSPMD_PLACEMENTS[placement]
    shutil.rmtree(nvme_dir, ignore_errors=True)
    return RunConfig(
        model=cfg, parallel=make_parallel("pjit", remat=remat),
        offload=make_offload(param_tier=param, grad_tier=grad, opt_tier=opt,
                             nvme_dir=nvme_dir),
        train=TrainConfig(lr=3e-3, steps=steps, seed=SEED))


# CPU sides of in-graph GSPMD runs, by (model, cut, B, S, steps): the
# future of (the side, its initial params) from the CPU sides' thread
# (``start_cpu_sides``). Every placement computes the same function, so
# a card run in any placement, and a model-axis run on ranks, is held
# against them
CPU_RUNS: dict = {}


def init_params(cfg) -> dict:
    """``cfg``'s params drawn from ``SEED`` on the CPU: every side of a
    numerics phase, and the ranks of "gspmd dp2 numerics", start from them.
    (A draw on the card is ~15 s faster for the hybrid's 1.7 B params, but
    gives other weights, and at the card's draw mamba2's second-step grad
    norm is rounding-sensitive beyond ``TRAIN_TOL``: PERF.md §7.)"""
    return registry.build(cfg).init(torch.Generator().manual_seed(SEED), torch.device("cpu"))


def gspmd_side(key: tuple, dev: str, placement: str = "in_graph", params0=None) -> tuple:
    """One side of a numerics phase (``key``: ``CPU_RUNS``' key, its model,
    cut, B x S and steps): the GSPMD engine in ``placement`` on ``dev``
    from ``params0`` (default ``init_params``' draw), the global batches
    of ``SEED``; its trajectory and its params and f32 masters flat."""
    arch, cut, B, S, steps = key
    cfg = dataclasses.replace(configs.get(arch), **dict(cut))
    params0 = init_params(cfg) if params0 is None else params0
    base = os.path.join(ROOT, "build", f"chip_smoke_gspmd_{arch}_{placement}")
    ex = InfinityExecutor(_gspmd_run(cfg, os.path.join(base, dev), steps, placement), dev)
    state = ex.reseed(ex.engine.adopt_params(params0))
    stream = SyntheticStream(ex.input_specs(ShapeConfig("n", S, B, "train")),
                             cfg.vocab_size, seed=SEED)
    step = ex.make_train_step()
    traj = []
    for i in range(steps):
        batch = {k: torch.from_numpy(a).to(dev) for k, a in stream.batch_at(i).items()}
        state, m = step(state, batch)
        traj.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    ex.wait_host()
    masters = (_store_masters(ex) if ex.offgraph else
               {k: v for k, v in zip(pt.tree_paths(state["opt"].master),
                                     pt.tree_leaves(state["opt"].master))})
    masters = torch.cat([t.detach().float().cpu().reshape(-1) for t in masters.values()])
    # NVMe-resident params are read back from the param store
    params = torch.cat([t.detach().float().cpu().reshape(-1)
                        for t in pt.tree_leaves(ex.checkpoint_state(state)["params"])])
    ex.close()  # the card's copy is freed with ``state`` on return
    return traj, params, masters


def phase_gspmd_numerics(placement: str = "in_graph", arch: str = "smollm-135m",
                         layers: int = 2, B: int = 4, S: int = 256,
                         tag: str = "gspmd numerics", cut: dict | None = None,
                         steps: int = 2) -> dict:
    """Full-width ``arch`` cut to ``layers`` layers (or by the config fields
    in ``cut``): ``steps`` steps of the GSPMD engine on the card (kernels)
    and on the CPU (plain versions), same weights and batches (B x S tokens), in
    one of ``GSPMD_PLACEMENTS``; loss and grad norm by ``TRAIN_TOL``, the
    f32 masters (in the state in-graph, read back from the optimizer store
    off-graph) by the drift bound, the params by it plus each side's bf16
    rounding, their mean by 2^-5 * sum(lr). The CPU side is the in-graph
    one of ``CPU_RUNS`` (every placement computes one function; its host
    Adam and NVMe traffic would double an off-graph phase's time), and
    the card starts from its initial params."""
    cut = cut or {"n_layers": layers}
    key = (arch, tuple(sorted(cut.items())), B, S, steps)
    t0 = time.perf_counter()
    runs = CPU_RUNS.pop(key) if key in CPU_SIDES_READ_ONCE else CPU_RUNS[key]
    cpu, params0 = runs.result()
    side_s = {"wait": time.perf_counter() - t0}  # where the phase's seconds go
    t0 = time.perf_counter()
    card = gspmd_side(key, "cuda", placement, params0)
    side_s["cuda"] = time.perf_counter() - t0
    cfg = dataclasses.replace(configs.get(arch), **cut)
    rec = {"arch": arch, "placement": placement,
           "tiers_param_grad_opt_remat": GSPMD_PLACEMENTS[placement],
           "cpu_side": "in_graph, kept", "cut": cut, "n_params": registry.build(cfg).n_params(),
           "d_model": cfg.d_model, "batch": B, "seq": S, "steps": steps, "side_s": side_s}
    t0 = time.perf_counter()
    rec = hold_card_to_cpu(tag, f"{arch}, {placement}", cpu, card, rec)
    say(f"{tag} compare: {time.perf_counter() - t0:.1f} s, sides {json.dumps(side_s)}")
    return rec


COMPARE_CHUNK = 1 << 27  # elements a slice of the card-side comparison holds


def hold_card_to_cpu(tag: str, what: str, cpu: tuple, card: tuple, rec: dict) -> dict:
    """``(trajectory, params, masters)`` of a card run against a CPU run of
    the same function: loss and grad norm by ``TRAIN_TOL``, the f32
    masters by the drift bound, the params by it plus each side's bf16
    rounding, their mean by 2^-5 * sum(lr). Prints ``rec`` with the
    numbers; fails the script beyond a bound. The elementwise comparison
    runs on the card (exact f32 arithmetic either way; over the hybrid's
    1.7 B elements the CPU took ~20 s), ``COMPARE_CHUNK`` elements at a
    time (whole, llava's 1.45 B elements took the card's memory)."""
    (tc, p_c, m_c), (tg, p_g, m_g) = cpu, card
    lrs = [t["lr"] for t in tc]
    drift = adam.parity_bound(TrainConfig(), lrs)
    p_max = p_sum = worst = m_max = 0.0
    within = True
    for i in range(0, p_c.numel(), COMPARE_CHUNK):
        a, b = (t[i:i + COMPARE_CHUNK].to("cuda") for t in (p_c, p_g))
        diff = (b - a).abs()
        allowed = drift + 2**-8 * (a.abs() + b.abs())
        p_max, p_sum = max(p_max, diff.max().item()), p_sum + diff.sum().item()
        worst = max(worst, (diff / allowed).max().item())
        within = within and bool((diff <= allowed).all())
    for i in range(0, m_c.numel(), COMPARE_CHUNK):
        a, b = (t[i:i + COMPARE_CHUNK].to("cuda") for t in (m_c, m_g))
        m_max = max(m_max, (b - a).abs().max().item())
    rec = {**rec, "cpu": tc, "card": tg, "tol": TRAIN_TOL,
           "params_max_abs_diff": p_max, "params_mean_abs_diff": p_sum / p_c.numel(),
           "params_worst_diff_over_bound": worst, "masters_max_abs_diff": m_max,
           "masters_worst_diff_over_drift": m_max / drift,
           "params_max_bound": drift, "params_mean_bound": 2**-5 * sum(lrs)}
    say(f"{tag}:", json.dumps(rec))
    for c, g in zip(tc, tg):
        for key in ("loss", "grad_norm"):
            if not abs(g[key] - c[key]) <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(c[key]):
                raise SystemExit(f"FAIL {tag} ({what}): card {key} {g[key]} vs CPU {c[key]}")
    if not m_max <= drift or not within \
            or not rec["params_mean_abs_diff"] <= rec["params_mean_bound"]:
        raise SystemExit(f"FAIL {tag} ({what}): params differ beyond the bound: {rec}")
    return rec


def phase_plan_train(tag: str, extra: list, arch: str = "smollm-135m", batch: int = 8,
                     seq: int = 512, layers: int = 0) -> tuple:
    """``launch.train --plan auto`` on ``arch`` at full width (its depth cut
    to ``layers`` when given) at the training cell's shape (``batch`` x
    ``seq``); ``extra`` adds flags (``--hw-device-mem``). Counters zeroed
    just before and read just after. A MoE model's steps also report the
    routing's dropped fraction and (E,) expert load."""
    cfg = configs.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        extra = extra + ["--layers", str(layers)]
    L, A, steps = cfg.n_layers, attention_layers(cfg), 4
    nvme = os.path.join(ROOT, "build", "chip_smoke_" + tag.replace(" ", "_"))
    shutil.rmtree(nvme, ignore_errors=True)
    argv = ["--arch", arch, "--plan", "auto", "--batch", str(batch), "--seq", str(seq),
            "--steps", str(steps), "--lr", "3e-3", "--nvme-dir", nvme,
            "--log-every", "1"] + extra
    trace.enable()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.train(train.build_argparser().parse_args(argv), argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    trace.disable()
    trace.clear()
    plan, run = hist["plan"], hist["run"]
    say(f"{tag} plan: {plan.summary()}")
    keep = ("opt_read_bytes", "opt_write_bytes", "opt_read_gbps", "opt_write_gbps",
            "grad_out_bytes", "plan_opt_step_bytes", "plan_grad_step_bytes",
            "plan_efficiency", "plan_peak_resident_param_bytes", "plan_residency_ok",
            "trace_wall_s", "trace_compute_s", "trace_io_wait_s", "trace_other_s",
            "moe_dropped_token_fraction", "moe_expert_load")
    for m in hist["metrics"]:
        say(f"{tag} step:", json.dumps({
            "step": m["step"], "loss": m["loss"], "grad_norm": m["grad_norm"],
            "lr": m["lr"], "step_s": m["step_time"], "tokens_per_s": m["tokens_per_s"],
            **{k: m[k] for k in keep if k in m}}))
    losses = hist["losses"]
    median = statistics.median(m["step_time"] for m in hist["metrics"][1:])
    n_leaves = len(pt.tree_paths(registry.build(cfg).defs))
    rec = {"argv": " ".join(argv), "wall_s": wall, "launches": launches,
           "plan": {"engine": plan.engine, "tiers": plan.tiers, "remat": plan.remat,
                    "grad_accum": plan.grad_accum, "feasible": plan.feasible,
                    "device_mem": plan.hardware.device_mem,
                    "host_mem": plan.hardware.host_mem,
                    "nvme_capacity": plan.hardware.nvme_capacity,
                    "source": plan.hardware.source, "warnings": list(plan.warnings)},
           "opt_offgraph": run.opt_offgraph, "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses, "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "median_step_s_after_first": median,
           "median_tokens_per_s_after_first": batch * seq / median, "n_leaves": n_leaves,
           "n_params": registry.build(cfg).n_params(), "layers": L}
    say(f"{tag}:", json.dumps(rec))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL {tag}: losses not finite or not falling: {losses}")
    if plan.engine != "pjit" or plan.param_tier != "device" or not plan.feasible:
        raise SystemExit(f"FAIL {tag}: the planner gave {plan.summary()}; this phase "
                         "runs the GSPMD step with params on the device")
    for m in hist["metrics"]:
        if "plan_residency_ok" in m and m["plan_residency_ok"] is not True:
            raise SystemExit(f"FAIL {tag}: plan_residency_ok false at step {m['step']}")
    remat = plan.remat == "full"
    want = {"flash_attention": (2 if remat else 1) * A * steps,
            "flash_attention_bwd": A * steps}
    if cfg.family in ("hybrid", "ssm"):
        # exactly the attention layers' launches: forward (again under
        # remat="full") and backward, every step
        for name, n in want.items():
            if launches[name] != n:
                raise SystemExit(f"FAIL {tag}: {name} launched {launches[name]} times; "
                                 f"want {n}")
    if cfg.family in MLP_FAMILIES:
        # each projection forward (again under remat="full"), then dX and dW
        want["tiled_matmul"] = ((2 if remat else 1) + 2) * mlp_products(cfg) * steps
    elif cfg.family == "moe":
        for m in hist["metrics"]:
            load = m["moe_expert_load"]
            if not (0.0 <= m["moe_dropped_token_fraction"] <= 1.0
                    and len(load) == cfg.n_experts and abs(sum(load) - 1.0) < 1e-3):
                raise SystemExit(f"FAIL {tag}: routing metrics at step {m['step']}: "
                                 f"dropped {m['moe_dropped_token_fraction']}, load {load}")
    if run.opt_offgraph:
        if plan.opt_tier == "device":
            raise SystemExit(f"FAIL {tag}: the optimizer stayed on the device")
        for m in hist["metrics"]:
            moved = m["opt_read_bytes"] + m["opt_write_bytes"]
            if not (m["opt_read_bytes"] > 0 and m["opt_write_bytes"] > 0
                    and m["plan_opt_step_bytes"] == moved):
                raise SystemExit(f"FAIL {tag}: step {m['step']} moved {moved} optimizer "
                                 f"bytes, the plan predicts {m.get('plan_opt_step_bytes')}")
    else:
        want["fused_adam"] = n_leaves * steps
    for name, n in want.items():
        if launches[name] < n:
            raise SystemExit(f"FAIL {tag}: {name} launched {launches[name]} < {n}")
    check_main_path_routes(tag, launches)
    check_window_launches(tag, launches, cfg)
    return rec, launches


def phase_plan_serve() -> tuple:
    """``launch.serve --plan auto`` at the serve host cell's sizes."""
    kv_dir = os.path.join(ROOT, "build", "chip_smoke_plan_kv")
    shutil.rmtree(kv_dir, ignore_errors=True)
    argv = ["--arch", "smollm-135m", "--plan", "auto", "--batch", "8", "--prompt-len", "512",
            "--new-tokens", "32", "--kv-dir", kv_dir]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.run_serve(serve._parse(argv), argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    plan = out["plan"]
    n = len(out["generated"])
    t = out["timings"]
    rec = {"run": "plan serve", "argv": " ".join(argv), "wall_s": wall,
           "plan": plan.summary(), "kv_tier": plan.kv_tier, "kv_slots": plan.kv_slots,
           "kv_block_tokens": plan.kv_block_tokens,
           "kv_prefetch_blocks": plan.kv_prefetch_blocks,
           "kv_resident_bytes": out["kv"]["resident_bytes"],
           "plan_kv_resident_bytes": plan.predictions["kv_resident_bytes"],
           "plan_kv_parked_bytes": plan.predictions["kv_parked_bytes"],
           "admissions": out["admissions"], "decode_steps": out["steps"],
           "prefill_tok_s": n * 512 / max(t["prefill_s"], 1e-9),
           "decode_tok_s": (sum(len(g) for g in out["generated"]) - n) / max(t["decode_s"], 1e-9),
           "ttft_p50_s": out["latency"]["ttft"]["p50"],
           "decode_token_p50_s": out["latency"]["decode_token"]["p50"], "launches": launches}
    say("plan serve:", json.dumps(rec))
    if not all(out["done"]) or any(len(g) != 32 for g in out["generated"]):
        raise SystemExit("FAIL plan serve: not every sequence finished its 32 tokens")
    if out["kv"]["resident_bytes"] > plan.predictions["kv_resident_bytes"]:
        raise SystemExit(f"FAIL plan serve: device KV {out['kv']['resident_bytes']} B > "
                         f"planned {plan.predictions['kv_resident_bytes']} B")
    L = configs.get("smollm-135m").n_layers
    waves = -(-n // out["slots"])
    if launches["flash_attention"] < L * waves or \
            launches["tiled_matmul"] < 3 * L * (waves + out["steps"]):
        raise SystemExit(f"FAIL plan serve: too few launches {launches}")
    check_main_path_routes("plan serve", launches)
    return rec, launches


def zero3_flat_elems() -> int:
    """Elements of full smollm-135m's (L, P) flat, the explicit step's
    fused-Adam operand."""
    run = RunConfig(model=configs.get("smollm-135m"), parallel=make_parallel("zero3"))
    eng = ExplicitZero3Engine(run, "cpu")
    return eng.n_layers * eng.layout.padded


def _zero3_run(cfg, nvme_dir, steps, placement) -> RunConfig:
    param, grad, opt, compress = ZERO3_PLACEMENTS[placement]
    shutil.rmtree(nvme_dir, ignore_errors=True)
    return RunConfig(
        model=cfg, parallel=make_parallel("zero3", remat="none", grad_compression=compress),
        offload=make_offload(param_tier=param, grad_tier=grad, opt_tier=opt,
                             nvme_dir=nvme_dir),
        train=TrainConfig(lr=3e-3, steps=steps, seed=SEED))


# the CPU side of the in-graph monolithic step, kept for the placements
# that compute the same function (all but int8, whose quantizer is another)
ZERO3_CPU_RUNS: dict = {}


def phase_zero3_numerics(placement: str, keep_cpu: bool = False,
                         reuse_cpu: bool = False) -> dict:
    """Full-width smollm-135m cut to 2 layers: 2 monolithic steps of the
    explicit engine on the card (kernels) and on the CPU (plain versions),
    same state and batches, in one of ``ZERO3_PLACEMENTS``; loss and grad
    norm by ``TRAIN_TOL`` (the grad norm by ``INT8_NORM_TOL`` under int8),
    the f32 masters (in the state in-graph, read back from the optimizer
    store off-graph) by the drift bound, the flat by it plus each side's
    bf16 rounding, its mean by 2^-5 * sum(lr). ``keep_cpu`` keeps the CPU
    side in ``ZERO3_CPU_RUNS``, ``reuse_cpu`` holds the card against it
    (the host and off-graph placements compute the in-graph function)."""
    cfg = dataclasses.replace(configs.get("smollm-135m"), n_layers=2)
    B, S, steps = 4, 256, 2
    base = os.path.join(ROOT, "build", f"chip_smoke_zero3_{placement}")
    # the seed's draw on the CPU: the kept CPU side's start too
    state0 = ExplicitZero3Engine(_zero3_run(cfg, os.path.join(base, "init"), steps, placement),
                                 "cpu").init_state(torch.Generator().manual_seed(SEED))
    out = {"cpu": ZERO3_CPU_RUNS["in_graph"]} if reuse_cpu else {}
    for dev in [d for d in ("cpu", "cuda") if d not in out]:
        ex = InfinityExecutor(_zero3_run(cfg, os.path.join(base, dev), steps, placement), dev)
        state = ex.reseed(ex.engine.place_state(_to(state0, dev)))
        stream = SyntheticStream(ex.input_specs(ShapeConfig("n", S, B, "train")),
                                 cfg.vocab_size, seed=SEED)
        step = ex.make_train_step()
        traj = []
        for i in range(steps):
            batch = {k: torch.from_numpy(a).to(dev) for k, a in stream.batch_at(i).items()}
            state, m = step(state, batch)
            traj.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        ex.wait_host()
        masters = _store_masters(ex)["rank0/flat"] if ex.offgraph else state["master"]
        out[dev] = (traj, state["flat"].detach().float().cpu(),
                    masters.detach().float().cpu().reshape(state["flat"].shape))
        ex.close()
    if keep_cpu:
        ZERO3_CPU_RUNS[placement] = out["cpu"]
    (tc, f_c, m_c), (tg, f_g, m_g) = out["cpu"], out["cuda"]
    lrs = [t["lr"] for t in tc]
    drift = adam.parity_bound(TrainConfig(), lrs)
    diff = (f_g - f_c).abs()
    allowed = drift + 2**-8 * (f_c.abs() + f_g.abs())
    rec = {"placement": placement, "tiers_param_grad_opt_compress": ZERO3_PLACEMENTS[placement],
           "cpu_side": "in_graph, kept" if reuse_cpu else placement, "layers": 2,
           "d_model": cfg.d_model, "batch": B, "seq": S, "steps": steps,
           "cpu": tc, "card": tg, "tol": TRAIN_TOL,
           "flat_max_abs_diff": diff.max().item(), "flat_mean_abs_diff": diff.mean().item(),
           "flat_worst_diff_over_bound": (diff / allowed).max().item(),
           "masters_max_abs_diff": (m_g - m_c).abs().max().item(),
           "masters_worst_diff_over_drift": (m_g - m_c).abs().max().item() / drift,
           "flat_max_bound": drift, "flat_mean_bound": 2**-5 * sum(lrs)}
    say("zero3 numerics:", json.dumps(rec))
    for c, g in zip(tc, tg):
        for key in ("loss", "grad_norm"):
            tol = INT8_NORM_TOL if (placement == "int8" and key == "grad_norm") else TRAIN_TOL
            if not abs(g[key] - c[key]) <= tol["atol"] + tol["rtol"] * abs(c[key]):
                raise SystemExit(f"FAIL zero3 numerics ({placement}): card {key} {g[key]} "
                                 f"vs CPU {c[key]}")
    if not rec["masters_max_abs_diff"] <= drift or not bool((diff <= allowed).all()) \
            or not rec["flat_mean_abs_diff"] <= rec["flat_mean_bound"]:
        raise SystemExit(f"FAIL zero3 numerics ({placement}): the flat differs beyond the "
                         f"bound: {rec}")
    return rec


def phase_zero3_train(tag: str, tiers: list) -> tuple:
    """``launch.train --engine zero3`` on full smollm-135m: the explicit
    engine's monolithic step, 6 steps of 8 x 512 tokens; ``tiers`` sets the
    params' and the optimizer's tiers (device or the pinned host tier).
    Counters zeroed just before and read just after."""
    cfg = configs.get("smollm-135m")
    L, steps = cfg.n_layers, 6
    argv = ["--arch", "smollm-135m", "--engine", "zero3", "--batch", "8", "--seq", "512",
            "--steps", str(steps), "--lr", "3e-3", "--ckpt-every", "0",
            "--log-every", "1"] + tiers
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.train(train.build_argparser().parse_args(argv), argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    for m in hist["metrics"]:
        say(f"{tag} step:", json.dumps({
            "step": m["step"], "loss": m["loss"], "grad_norm": m["grad_norm"], "lr": m["lr"],
            "step_s": m["step_time"], "tokens_per_s": m["tokens_per_s"]}))
    losses = hist["losses"]
    median = statistics.median(m["step_time"] for m in hist["metrics"][1:])
    rec = {"argv": " ".join(argv), "wall_s": wall, "launches": launches,
           "first_loss": losses[0], "last_loss": losses[-1],
           "median_step_s_after_first": median,
           "median_tokens_per_s_after_first": 8 * 512 / median}
    say(f"{tag}:", json.dumps(rec))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL {tag}: losses not finite or not falling: {losses}")
    # remat "full" (the CLI default): flash forward in every layer and again
    # in its recompute, one backward; three MLP products forward, three in
    # the recompute, two gradient products each; fused Adam on the flat and
    # on the two 'other' leaves (embedding, final norm) every step
    want = {"flash_attention": 2 * L * steps, "flash_attention_bwd": L * steps,
            "tiled_matmul": (6 + 6) * L * steps, "fused_adam": 3 * steps}
    for name, n in want.items():
        if launches[name] < n:
            raise SystemExit(f"FAIL {tag}: {name} launched {launches[name]} < {n}")
    check_main_path_routes(tag, launches)
    return rec, launches


# ---------------------------------------------------------------------------
# data parallel: two ranks on the one card (gloo), one process each
# ---------------------------------------------------------------------------

# case -> (param, grad, opt tiers, grad_compression): the monolithic step in
# allgather mode all on the device, with int8 compression, and the layered
# epoch with every state class on NVMe
DP2_CASES = {"allgather": ("device", "device", "device", "none"),
             "int8": ("device", "device", "device", "int8"),
             "layered_nvme": ("nvme", "nvme", "nvme", "none")}
DP_TRAIN_STEPS = 4
TIERS = ("param_in", "param_out", "grad_out", "opt_read", "opt_write")


def _rank_record(mode: str, rank: int) -> str:
    """Where rank ``rank`` of a ``--dp-rank <mode>`` run writes its record
    (one file a rank: the ranks share one stdout, whose lines interleave)."""
    return os.path.join(ROOT, "build", f"chip_smoke_dp_{mode}.rank{rank}.json")


def run_ranks(mode: str, timeout: float, n: int = 2) -> list:
    """``chip_smoke.py --dp-rank <mode>`` on ``n`` ranks through torchrun's
    launcher (``--standalone``: a rendezvous on this host); each rank's
    record in rank order, the ranks' output echoed. Fails the script if a
    rank fails or the launch outlives ``timeout``."""
    paths = [_rank_record(mode, r) for r in range(n)]
    for path in paths:
        if os.path.exists(path):
            os.remove(path)
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or n) // n)),
               PYTHONPATH=os.path.join(ROOT, "src"))
    # its own process group, so a timeout takes the ranks down with the launcher
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc-per-node", str(n), os.path.abspath(__file__),
                             "--dp-rank", mode], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SystemExit(f"FAIL dp {mode}: the ranks outlived {timeout} s; killed")
    for line in stdout.splitlines():
        if line.strip():
            say(f"  {line}")
    if proc.returncode or not all(os.path.exists(p) for p in paths):
        raise SystemExit(f"FAIL dp {mode}: rc {proc.returncode}\n{stdout[-3000:]}\n"
                         f"{stderr[-3000:]}")
    recs = []
    for path in paths:
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _sum_launches(recs) -> dict:
    """The ranks' launch counters summed: every launch on the card."""
    return {k: sum(r["launches"][k] for r in recs) for k in recs[0]["launches"]}


def dp2_numerics_rank() -> dict:
    """(a rank) Full-width smollm-135m cut to 2 layers, 2 steps of each of
    ``DP2_CASES`` on 2 ranks on the card (kernels) and on 2 ranks on the
    CPU (plain versions), the same global state (drawn whole, each rank
    its shard) and global batches (each rank its rows); this rank's loss,
    grad norm (summed over the ranks), rows and f32 masters held card
    against CPU by ``phase_zero3_numerics``' bounds."""
    meshes = {dev: mesh_mod.make_local_mesh(2, 1, dev) for dev in ("cpu", "cuda")}
    rank = meshes["cpu"].rank
    cfg = dataclasses.replace(configs.get("smollm-135m"), n_layers=2)
    B, S, steps = 4, 128, 2
    recs, failures = [], []
    ops.reset_launch_counts()
    for case, (param, grad, opt, compress) in DP2_CASES.items():
        base = os.path.join(ROOT, "build", f"chip_smoke_dp2_{case}")
        state0, out = None, {}
        for dev in ("cpu", "cuda"):
            mesh = meshes[dev]
            nvme = os.path.join(base, dev)
            run = RunConfig(model=cfg, parallel=make_parallel("zero3", remat="none",
                                                              grad_compression=compress),
                            offload=make_offload(param_tier=param, grad_tier=grad, opt_tier=opt,
                                                 nvme_dir=nvme),
                            train=TrainConfig(lr=3e-3, steps=steps, seed=SEED))
            ex = InfinityExecutor(run, mesh.device, mesh=mesh)
            if state0 is None:
                state0 = ex.engine.init_state(torch.Generator().manual_seed(SEED))
            state = ex.reseed(ex.engine.place_state(_to(state0, mesh.device)))
            stream = SyntheticStream(ex.input_specs(ShapeConfig("n", S, B, "train")),
                                     cfg.vocab_size, seed=SEED)
            step = ex.make_train_step()
            traj = []
            for i in range(steps):
                batch = {k: torch.from_numpy(a).to(mesh.device)
                         for k, a in rank_slice(stream.batch_at(i), rank, 2).items()}
                state, m = step(state, batch)
                traj.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
            rows = ex.materialize_flat() if ex.layered else state["flat"]
            masters = _masters(ex) if ex.layered else state["master"]
            out[dev] = (traj, rows.detach().float().cpu(), masters.detach().float().cpu())
            ex.close()
            shutil.rmtree(os.path.join(nvme, ex.rank_key), ignore_errors=True)
        (tc, f_c, m_c), (tg, f_g, m_g) = out["cpu"], out["cuda"]
        lrs = [t["lr"] for t in tc]
        drift = adam.parity_bound(TrainConfig(), lrs)
        diff = (f_g - f_c).abs()
        allowed = drift + 2**-8 * (f_c.abs() + f_g.abs())
        rec = {"case": case, "rank": rank, "tiers_param_grad_opt_compress": DP2_CASES[case],
               "layers": 2, "d_model": cfg.d_model, "global_batch": B, "seq": S,
               "steps": steps, "rows_shape": list(f_g.shape), "cpu": tc, "card": tg,
               "flat_max_abs_diff": diff.max().item(), "flat_mean_abs_diff": diff.mean().item(),
               "flat_worst_diff_over_bound": (diff / allowed).max().item(),
               "masters_worst_diff_over_drift": (m_g - m_c).abs().max().item() / drift,
               "flat_mean_bound": 2**-5 * sum(lrs)}
        for c, g in zip(tc, tg):
            for key in ("loss", "grad_norm"):
                tol = INT8_NORM_TOL if (case == "int8" and key == "grad_norm") else TRAIN_TOL
                if not abs(g[key] - c[key]) <= tol["atol"] + tol["rtol"] * abs(c[key]):
                    failures.append(f"{case}: card {key} {g[key]} vs CPU {c[key]}")
        if not rec["masters_worst_diff_over_drift"] <= 1 or not bool((diff <= allowed).all()) \
                or not rec["flat_mean_abs_diff"] <= rec["flat_mean_bound"]:
            failures.append(f"{case}: the rows differ beyond the bound")
        recs.append(rec)
    for kind in DP2_CARD_CASES:
        dp2_card_case(kind, meshes["cuda"])
    return {"rank": rank, "cases": recs, "failures": failures,
            "launches": ops.launch_counts(), "transport": meshes["cuda"].transport()}


# the layered epoch's cases of "zero3 dp2 numerics" run on the card alone:
# each is held against the one-rank CPU side its one-rank numerics phase
# kept (the same function on the same weights and global batches): q8 rows
# ("train numerics q8", full-width smollm-135m cut to 2 layers) and MoE's
# expert rows ("moe numerics/layered", granite-moe-1b-a400m cut to 2)
DP2_CARD_CASES = ("q8", "moe")


def _dp2_card_record(kind: str, rank: int) -> str:
    return os.path.join(ROOT, "build", f"chip_smoke_dp2_{kind}.rank{rank}.pt")


def dp2_card_case(kind: str, mesh) -> None:
    """(a rank) ``kind``'s layered run on 2 ranks on the card, from the
    global state its one-rank numerics phase draws (on a one-rank CPU
    engine, each rank keeping its slices) on the rank's rows of the same
    global batches; saves the rank's trajectory, rows, masters by opt-store
    key and, for MoE, its routing plans and 'other' leaves."""
    rank, dev = mesh.rank, mesh.device
    if kind == "q8":
        layers, B, S, steps = TRAIN_NUMERICS
        cfg = dataclasses.replace(configs.get("smollm-135m"), n_layers=layers)
        quant = "q8"
    else:
        layers, B, S, steps = MOE_NUMERICS
        cfg = dataclasses.replace(configs.get(MOE_ARCH), n_layers=layers)
        quant = "none"
    nvme = os.path.join(ROOT, "build", f"chip_smoke_dp2_{kind}")
    shutil.rmtree(os.path.join(nvme, f"rank{rank}"), ignore_errors=True)
    run = RunConfig(model=cfg, parallel=make_parallel("zero3", remat="none"),
                    offload=make_offload(opt_tier="nvme", param_tier="nvme", grad_tier="nvme",
                                         nvme_dir=nvme, param_quant=quant),
                    train=TrainConfig(lr=3e-3, steps=steps, seed=SEED))
    state0 = ExplicitZero3Engine(run, "cpu").init_state(torch.Generator().manual_seed(SEED))
    ex = InfinityExecutor(run, dev, mesh=mesh)
    state = ex.reseed(ex.engine.place_state(_to(bridge.shard_zero3_state(state0, rank, 2), dev)))
    stream = SyntheticStream(ex.input_specs(ShapeConfig("n", S, B, "train")),
                             cfg.vocab_size, seed=SEED)
    step = ex.make_train_step()
    traj = []
    with RoutingRecorder() as rr:
        for i in range(steps):
            batch = {k: torch.from_numpy(a).to(dev)
                     for k, a in rank_slice(stream.batch_at(i), rank, 2).items()}
            state, m = step(state, batch)
            traj.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
            if kind == "moe":
                traj[-1]["moe_dropped_token_fraction"] = float(m["moe_dropped_token_fraction"])
                traj[-1]["moe_expert_load"] = m["moe_expert_load"].double().tolist()
    rows = {k: v.float() for k, v in ex.materialize_rows().items()}
    out = {"traj": traj, "rows": rows, "masters": _store_masters(ex), "plans": rr.plans,
           "other": pt.tree_map(lambda t: t.detach().cpu(), state["other"]),
           "quantized_leaves": ex.engine.quantized_leaves}
    ex.close()
    torch.save(out, _dp2_card_record(kind, rank))


def _join_rank_masters(cpu_masters: dict, ranks: list) -> dict:
    """The ranks' opt-store masters (``rank<r>/l<i>``, ``xrank<r>/l<j>``:
    their slices) put together in the one-rank run's key order."""
    out = {}
    for key in cpu_masters:
        prefix, row = key.split("/")
        out[key] = torch.cat([r["masters"][f"{prefix[:-1]}{i}/{row}"]
                              for i, r in enumerate(ranks)])
    return out


def hold_dp2_card_cases() -> dict:
    """The ranks' records of ``DP2_CARD_CASES`` put together (rows and
    masters by columns, plans by groups: each rank routes its rows' groups)
    and held against the kept one-rank CPU sides by
    ``hold_rows_to_cpu`` / ``hold_moe_to_cpu``; both ranks report one
    trajectory."""
    out = {}
    for kind in DP2_CARD_CASES:
        ranks = [torch.load(_dp2_card_record(kind, r), weights_only=False) for r in range(2)]
        if ranks[0]["traj"] != ranks[1]["traj"]:
            raise SystemExit(f"FAIL zero3 dp2 numerics ({kind}): the ranks report "
                             f"{ranks[0]['traj']} and {ranks[1]['traj']}")
        rows = {k: torch.cat([r["rows"][k] for r in ranks], dim=1) for k in ranks[0]["rows"]}
        rec = {"case": f"{kind}_layered", "ranks": 2, "cpu_side": "one rank, kept",
               "quantized_leaves": ["/".join(p) for p in ranks[0]["quantized_leaves"]]}
        if kind == "q8":
            cpu = LAYERED_CPU_RUNS["q8"]
            masters = torch.stack(list(_join_rank_masters(
                {f"rank0/l{i}": None for i in range(cpu[2].shape[0])}, ranks).values()))
            out[kind] = hold_rows_to_cpu("zero3 dp2 numerics", "q8", cpu,
                                         (ranks[0]["traj"], rows["flat"], masters.float()), rec)
            continue
        cpu = MOE_CPU_RUNS["layered"]
        other = torch.cat([rows["flat"].reshape(-1)] + [t.float().reshape(-1) for t in
                                                        pt.tree_leaves(ranks[0]["other"])])
        plans = [torch.cat([r["plans"][i] for r in ranks]) for i in range(len(ranks[0]["plans"]))]
        cfg = dataclasses.replace(configs.get(MOE_ARCH), n_layers=MOE_NUMERICS[0])
        card = (ranks[0]["traj"], other, rows["eflat"], _join_rank_masters(cpu[3], ranks), plans)
        out[kind] = hold_moe_to_cpu("zero3 dp2 numerics", cfg, cpu, card,
                                    {**rec, "kind": "layered"})
    return out


def _depth(arch: str, layers: int) -> list:
    return ["--arch", arch] + (["--layers", str(layers)] if layers else [])


def dp_train_rank(arch: str = "smollm-135m", layers: int = 0,
                  steps: int = DP_TRAIN_STEPS) -> dict:
    """(a rank) ``launch.train --engine zero3 --data-mesh N`` (N the
    launch's world size) on ``arch`` at full width (its depth cut to
    ``layers``; 0: whole), the layered epoch with params, grads and
    optimizer on NVMe (MoE: its expert rows paged as units, each rank's
    slices), ``steps`` steps of 8 x 512 (8 / N x 512 a rank), tracer on;
    this rank's step metrics (the wall's compute / io_wait / other split,
    the collectives' waits among io_wait; MoE's routing statistics and
    expert counters), launches, peak allocated memory and transport.
    smollm's run checkpoints after its last step into ``CKPT_ZERO3_DIR``
    (rank 0 writes the rows gathered over the ranks), which "ckpt zero3
    reshard" restores on one rank."""
    n = int(os.environ["WORLD_SIZE"])
    nvme = os.path.join(ROOT, "build", f"chip_smoke_nvme_dp{n}_{arch}")
    shutil.rmtree(os.path.join(nvme, f"rank{os.environ['RANK']}"), ignore_errors=True)
    ckpt = (["--ckpt-every", str(steps), "--ckpt-dir", CKPT_ZERO3_DIR]
            if arch == "smollm-135m" and not layers else ["--ckpt-every", "0"])
    argv = _depth(arch, layers) + [
        "--engine", "zero3", "--data-mesh", str(n),
        "--offload-param", "nvme", "--offload-grad", "nvme", "--offload-opt", "nvme",
        "--batch", "8", "--seq", "512", "--steps", str(steps), "--lr", "3e-3",
        "--nvme-dir", nvme, *ckpt, "--log-every", "1"]
    trace.enable()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.train(train.build_argparser().parse_args(argv), argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trace.disable()
    trace.clear()
    keys = [f"{t}_bytes" for t in TIERS] + ["param_total_bytes", "peak_resident_param_bytes"]
    stats = ()
    if "expert_total_bytes" in hist["metrics"][0]:
        keys += ["expert_total_bytes", "expert_peak_resident_bytes"]
        stats = ("moe_dropped_token_fraction", "moe_expert_load", "expert_evictions",
                 "expert_prefetch_hit_rate")

    def fracs(m):
        w = max(m["trace_wall_s"], 1e-12)
        return {"compute_frac": m["trace_compute_s"] / w,
                "io_wait_frac": m["trace_io_wait_s"] / w,
                "io_wait_collective_frac": m.get("trace_io_wait_collective_s", 0.0) / w,
                "other_frac": m["trace_other_s"] / w}

    return {"rank": hist["mesh"].rank, "argv": " ".join(argv), "wall_s": wall,
            "launches": ops.launch_counts(), "transport": hist["mesh"].transport(),
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "steps": [{"step": m["step"], "loss": m["loss"], "grad_norm": m["grad_norm"],
                       "step_s": m["step_time"], "tokens_per_s": m["tokens_per_s"], **fracs(m),
                       **{k: m[k] for k in keys + list(stats)},
                       **{f"{k}_all_ranks": m[f"{k}_all_ranks"] for k in keys}}
                      for m in hist["metrics"]]}


def dp_rank(mode: str) -> int:
    """A rank's side of the dp phases, started by ``run_ranks``, on the
    backend ``mesh.choose_backend`` picks (gloo for ranks that share the
    card, NCCL for ranks with a card each); writes its record to
    ``_rank_record``. ``mode``: "all" (``DP_PARTS``), "tp3"
    (``TP3_PARTS``), a part, or parts joined by commas (one record a
    part)."""
    if not torch.cuda.is_available():
        print("dp rank: CUDA is not available")
        return 1
    # the rank joins once: launch.train then runs in the group it finds, so
    # one spawn runs every job ("all": ``DP_PARTS``, each rank's record by
    # part) and trains more than one model ("<mode>+moe")
    created = mesh_mod.maybe_init_distributed("cuda")
    try:
        rec = {}
        parts = {"all": DP_PARTS, "tp3": TP3_PARTS}.get(mode, tuple(mode.split(",")))
        for part in parts:
            base, _, extra = part.partition("+")
            rec[part] = {"numerics": dp2_numerics_rank,
                         "gspmd_numerics": gspmd_dp2_numerics_rank,
                         "train": dp_train_rank, "gspmd_train": gspmd_train_rank,
                         "serve": lambda: serve_rank(TP_SERVE_ARGV),
                         "cp_numerics": tp_numerics_rank,
                         "tp_numerics": tp_numerics_rank, "cp_train": tp_train_rank,
                         "tp_train": tp_train_rank, "tp_serve": tp_serve_rank,
                         "cp_serve": cp_serve_rank,
                         "moe_tp_numerics": lambda: moe_model_axis_numerics_rank("tp"),
                         "moe_cp_numerics": lambda: moe_model_axis_numerics_rank("cp"),
                         "moe_tp_train": lambda: tp_train_rank(
                             MOE_ARCH, MOE_LAYERED_LAYERS, 8, 512, MOE_TRAIN_STEPS),
                         "moe_tp_serve": lambda: serve_rank(
                             MOE_SERVE_ARGV + ["--model-mesh", "2"], model=2),
                         "ssm_cp_numerics": lambda: tp_numerics_rank(SSM_NUMERICS_KEY,
                                                                     "ssm_cp_numerics"),
                         "ssm_cp_train": lambda: tp_train_rank(
                             SSM_ARCH, steps=RECURRENT_TRAIN_STEPS),
                         "ssm_cp_serve": lambda: serve_rank(
                             SSM_SERVE_ARGV + ["--model-mesh", "2"], model=2),
                         "hybrid_tp_train": lambda: tp_train_rank(
                             HYBRID_ARCH, HYBRID_TRAIN_LAYERS, 1, 4096,
                             RECURRENT_TRAIN_STEPS),
                         "hybrid_tp_serve": lambda: serve_rank(
                             HYBRID_SERVE_ARGV + ["--model-mesh", "2"], model=2),
                         "encdec_tp_numerics": lambda: tp_numerics_rank(
                             ENCDEC_NUMERICS_KEY, "encdec_tp_numerics"),
                         "encdec_cp_numerics": lambda: tp_numerics_rank(
                             ENCDEC_NUMERICS_KEY, "encdec_cp_numerics", "cp"),
                         "encdec_tp_train": lambda: tp_train_rank(
                             ENCDEC_ARCH, steps=RECURRENT_TRAIN_STEPS, seq=2048),
                         "encdec_tp_serve": lambda: serve_rank(
                             ENCDEC_TP_SERVE_ARGV + ["--model-mesh", "2"], model=2),
                         "encdec_cp_serve": encdec_cp_serve_rank,
                         "vlm_serve": lambda: serve_rank(
                             VLM_SERVE_ARGV + ["--layers", str(VLM_SERVE_LAYERS)]),
                         "vlm_serve_full": lambda: serve_rank(VLM_SERVE_ARGV),
                         "vlm_serve_full_tp": lambda: serve_rank(
                             VLM_SERVE_ARGV + ["--model-mesh", "4"], model=4),
                         "vlm_tp_train": lambda: tp_train_rank(
                             VLM_ARCH, VLM_TRAIN_LAYERS, 1, 4096),
                         "gspmd_nvme_train": nvme_train_rank,
                         "gspmd_nvme_q8_train": lambda: nvme_train_rank(quant="q8"),
                         "cp_nvme_train": lambda: nvme_train_rank(model=2),
                         "ckpt_drill": ckpt_drill_rank}[base]()
            if extra == "moe":
                rec[part]["moe"] = (dp_train_rank if base == "train" else gspmd_train_rank)(
                    MOE_ARCH, MOE_LAYERED_LAYERS, MOE_TRAIN_STEPS)
            rec["rank"] = rec[part]["rank"]
        if len(parts) == 1 and mode not in ("all", "tp3"):
            rec = rec[mode]
    finally:
        if created:
            torch.distributed.destroy_process_group()
    with open(_rank_record(mode, rec["rank"]), "w") as f:
        json.dump(rec, f)
    return 0


def _part(recs, part: str, n: int = 2) -> list:
    """Each rank's record of ``part``: from the ranks' one spawn of every
    dp-2 job (``recs``, ``DP_PARTS``), or from a spawn of its own."""
    return [r[part] for r in recs] if recs is not None else run_ranks(part, 900, n)


def phase_zero3_dp2_numerics(recs=None) -> tuple:
    """Both ranks' ``dp2_numerics_rank``: every case within its bounds on
    each rank, the CUDA side's launches on the tensor-core routes."""
    t0 = time.perf_counter()
    recs = _part(recs, "numerics")
    for r in recs:
        for case in r["cases"]:
            say("zero3 dp2 numerics:", json.dumps(case))
        say("zero3 dp2 numerics launches:", json.dumps({"rank": r["rank"],
                                                        "launches": r["launches"],
                                                        "transport": r["transport"]}))
        if r["failures"]:
            raise SystemExit(f"FAIL zero3 dp2 numerics (rank {r['rank']}): {r['failures']}")
        check_main_path_routes("zero3 dp2 numerics", r["launches"])
    launches = _sum_launches(recs)
    card = hold_dp2_card_cases()
    rec = {"phase_s": time.perf_counter() - t0, "transport": recs[0]["transport"],
           "masters_worst_diff_over_drift": max(
               [c["masters_worst_diff_over_drift"] for r in recs for c in r["cases"]]
               + [c["masters_worst_diff_over_drift"] for c in card.values()])}
    say("zero3 dp2 numerics phase:", json.dumps(rec))
    return rec, launches


def phase_zero3_dp_train(dp1: dict, n: int = 2, tag: str = "zero3 dp2 train",
                         mode: str = "train", recs=None) -> tuple:
    """``n`` ranks' ``dp_train_rank``: the losses finite, falling and those
    of the one-rank layered run (``dp1``, phase 9: the same seed and global
    batches) by ``TRAIN_TOL``; each rank's tier bytes per step an n-th of
    the one-rank run's, their sum equal to it; each rank's launches those
    of a one-rank step, all on the tensor cores. ``mode`` "train+moe" also
    trains MoE in the same spawn (``phase_moe_dp_train`` reads it): the
    ranks' records come back third."""
    L = configs.get("smollm-135m").n_layers
    recs = _part(recs, mode, n)
    for r in recs:
        for m in r["steps"]:
            say(f"{tag} step:", json.dumps({"rank": r["rank"], **m}))
    rec = {"argv": recs[0]["argv"], "transport": recs[0]["transport"],
           "wall_s": [r["wall_s"] for r in recs],
           "peak_allocated_gb": [r["peak_allocated_gb"] for r in recs],
           "launches_per_rank": [r["launches"] for r in recs],
           "losses": [m["loss"] for m in recs[0]["steps"]],
           "dp1_losses": dp1["losses"][:DP_TRAIN_STEPS],
           "median_step_s_after_first": statistics.median(
               m["step_s"] for m in recs[0]["steps"][1:]),
           "bytes_per_rank": {k: recs[0]["steps"][-1][k] for k in dp1["step_bytes"]},
           "dp1_bytes": dp1["step_bytes"]}
    rec["median_tokens_per_s_after_first"] = 8 * 512 / rec["median_step_s_after_first"]
    say(f"{tag}:", json.dumps(rec))
    losses = rec["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL {tag}: losses not finite or not falling: {losses}")
    for got, want in zip(losses, rec["dp1_losses"]):
        if not abs(got - want) <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(want):
            raise SystemExit(f"FAIL {tag}: loss {got} vs the one-rank run's {want}")
    for r in recs:
        for m in r["steps"]:
            for k, whole in dp1["step_bytes"].items():
                if not (n * m[k] == whole and m[f"{k}_all_ranks"] == whole):
                    raise SystemExit(f"FAIL {tag}: rank {r['rank']} step {m['step']} {k} {m[k]} "
                                     f"(all ranks {m[f'{k}_all_ranks']}), the one-rank run's "
                                     f"{whole}")
        steps = DP_TRAIN_STEPS
        want = {"flash_attention": 2 * L * steps, "flash_attention_bwd": L * steps,
                "tiled_matmul": 12 * L * steps, "fused_adam": 2 * steps}
        for name, count in want.items():
            if r["launches"][name] < count:
                raise SystemExit(f"FAIL {tag}: rank {r['rank']} launched {name} "
                                 f"{r['launches'][name]} < {count}")
        check_main_path_routes(tag, r["launches"])
    return rec, _sum_launches(recs), recs


# "moe layered"'s steps, and the dp-2 MoE runs' held against it (2, not 3:
# chip_smoke.py's time budget)
MOE_TRAIN_STEPS = 2
# the dp-2 jobs one spawn of two ranks runs (``--dp-rank all``), in order:
# a spawn costs ~17 s of process start, imports and CUDA contexts
DP_PARTS = ("numerics", "train+moe", "gspmd_numerics", "gspmd_train+moe", "serve",
            "cp_numerics", "cp_train", "cp_serve", "moe_tp_numerics", "moe_cp_numerics",
            "moe_tp_train", "moe_tp_serve", "ssm_cp_numerics", "ssm_cp_train", "ssm_cp_serve",
            "hybrid_tp_train", "hybrid_tp_serve", "encdec_tp_numerics", "encdec_cp_numerics",
            "encdec_tp_train", "encdec_tp_serve", "encdec_cp_serve", "gspmd_nvme_train",
            "gspmd_nvme_q8_train", "cp_nvme_train", "ckpt_drill")
# the MoE layered epoch's counters the routing steers: the expert rows the
# popularity predictor, the hot cache and the router read and drain
MOE_STEERED = ("param_in_bytes", "grad_out_bytes")


def phase_moe_dp_train(dp1: dict, recs: list, tag: str = "moe dp2 train") -> tuple:
    """The MoE part of the ranks' "train+moe" spawn: ``launch.train
    --engine zero3 --data-mesh 2`` on granite-moe-1b-a400m at full width
    cut to ``MOE_LAYERED_LAYERS``, expert rows paged from NVMe and every
    state class there, ``MOE_TRAIN_STEPS`` steps of 8 x 512. Each rank's
    tier and expert bytes per step half of the one-rank "moe layered"
    run's (``dp1``: the same seed and global batches), their sum equal to
    it; the losses that run's by ``TRAIN_TOL``, finite and falling; the
    routing statistics equal on both ranks; the launches on the tensor
    cores. The expert rows read and drained (``MOE_STEERED``) follow the
    routing: once the two runs' updates have rounded apart, a near-tied
    token may take another expert and the popularity predictor and hot
    cache another row, so from the second step on those counters may
    differ from the one-rank run's by whole expert rows (at most a wave a
    layer), each rank its slice of them: counted and printed as
    ``expert_rows_apart``."""
    L, steps, n = MOE_LAYERED_LAYERS, MOE_TRAIN_STEPS, len(recs)
    cfg = configs.get(MOE_ARCH)
    apart = []
    parts = [r["moe"] for r in recs]
    for r in parts:
        for m in r["steps"]:
            say(f"{tag} step:", json.dumps({"rank": r["rank"], **m}))
    p0 = parts[0]
    rec = {"argv": p0["argv"], "transport": p0["transport"],
           "wall_s": [r["wall_s"] for r in parts],
           "peak_allocated_gb": [r["peak_allocated_gb"] for r in parts],
           "dp1_peak_allocated_gb": dp1.get("peak_allocated_gb"),
           "launches_per_rank": [r["launches"] for r in parts],
           "losses": [m["loss"] for m in p0["steps"]], "dp1_losses": dp1["losses"][:steps],
           "bytes_per_rank": {k: p0["steps"][-1][k] for k in dp1["step_bytes"][-1]},
           "dp1_bytes": dp1["step_bytes"][-1],
           "median_step_s_after_first": statistics.median(m["step_s"] for m in p0["steps"][1:]),
           "dp1_median_step_s_after_first": dp1["median_step_s_after_first"]}
    rec["median_tokens_per_s_after_first"] = 8 * 512 / rec["median_step_s_after_first"]
    say(f"{tag}:", json.dumps(rec))
    losses = rec["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL {tag}: losses not finite or not falling: {losses}")
    for got, want in zip(losses, rec["dp1_losses"]):
        if not abs(got - want) <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(want):
            raise SystemExit(f"FAIL {tag}: loss {got} vs the one-rank run's {want}")
    for i in range(steps):
        ms = [r["steps"][i] for r in parts]
        for key in ("moe_dropped_token_fraction", "moe_expert_load"):
            if any(m[key] != ms[0][key] for m in ms):
                raise SystemExit(f"FAIL {tag}: the ranks report {key} {[m[key] for m in ms]}")
        row = dp1["step_bytes"][i]["expert_total_bytes"] // (L * cfg.n_experts)
        apart.append({})
        for k, whole in dp1["step_bytes"][i].items():
            rows, rest = divmod(ms[0][f"{k}_all_ranks"] - whole, row)
            for m in ms:
                exact = n * m[k] == whole and m[f"{k}_all_ranks"] == whole
                steered = (k in MOE_STEERED and i > 0 and n * m[k] == m[f"{k}_all_ranks"]
                           and rest == 0 and abs(rows) <= cfg.top_k * L)
                if not (exact or steered):
                    raise SystemExit(f"FAIL {tag}: step {i} {k} {m[k]} (all ranks "
                                     f"{m[f'{k}_all_ranks']}), the one-rank run's {whole}")
            if k in MOE_STEERED:
                apart[-1][k] = rows
    rec["expert_rows_apart"] = apart
    say(f"{tag} expert rows apart:", json.dumps(apart))
    want = {"flash_attention": 3 * L * steps, "flash_attention_bwd": L * steps,
            "fused_adam": 3 * steps}
    for r in parts:
        for name, count in want.items():
            if r["launches"][name] < count:
                raise SystemExit(f"FAIL {tag}: rank {r['rank']} launched {name} "
                                 f"{r['launches'][name]} < {count}")
        check_main_path_routes(tag, r["launches"])
    return rec, _sum_launches(parts)


# ---------------------------------------------------------------------------
# serving on data-parallel ranks: each rank its ZeRO-3 param shards, its
# slots and its KV store
# ---------------------------------------------------------------------------

# the serve host cell (phase 5): 8 sequences, 4 slots, host tier
SERVE_ARGV = ["--arch", "smollm-135m", "--batch", "8", "--kv-slots", "4",
              "--kv-tier", "host", "--prompt-len", "512", "--new-tokens", "32"]
# llava at its serve cell's sizes, for --nccl-check's four-rank runs
VLM_SERVE_ARGV = ["--arch", VLM_ARCH, "--batch", "8", "--kv-slots", "4", "--kv-tier", "host",
                  "--prompt-len", "3072", "--new-tokens", "16"]
SERVE_KV = ("resident_bytes", "in_bytes", "out_bytes", "in_wire_bytes", "out_wire_bytes")


def serve_rank(argv=None, model: int = 1, strategy: str = "auto", cfg=None) -> dict:
    """(a rank) ``launch.serve --data-mesh N / model`` (N the launch's
    world size; ``argv`` names ``--model-mesh model`` where it is not 1)
    with ``argv`` (default the serve host cell's), its run's config
    forcing the attention ``strategy`` and serving ``cfg`` in place of
    ``--arch``'s where given: the run as this rank returns it (every
    sequence's tokens, the summed and per-rank KV bytes, each rank's param
    shard and peak allocated bytes), this rank's launches, and the param
    bytes of one rank and of this rank's layout."""
    n, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    argv = list(argv or SERVE_ARGV) + ["--data-mesh", str(n // model)]
    args = serve._parse(argv)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.run_serve(args, argv, cfg, strategy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cfg = configs.with_layers(cfg or (configs.smoke(args.arch) if args.smoke
                                      else configs.get(args.arch)), args.layers)
    run = RunConfig(model=cfg, parallel=make_parallel("pjit", attn_strategy=strategy))
    layout = ZeroInfinityEngine(run, "cpu", mesh=mesh_mod.LocalMesh(
        n // model, model, rank, n, torch.device("cpu"), None, "gloo"))
    cap = args.prompt_len + args.new_tokens
    t = out["timings"]
    return {"rank": rank, "argv": " ".join(argv), "wall_s": wall, "launches": ops.launch_counts(),
            "backend": out["mesh"]["backend"], "slots": out["slots"],
            "generated": out["generated"], "done": out["done"], "steps": out["steps"],
            "admissions": out["admissions"], "admissions_ranks": out["admissions_ranks"],
            "kv": out["kv"], "kv_ranks": out["kv_ranks"],
            "param_shard_bytes": out["param_shard_bytes"],
            "peak_allocated_bytes": out["peak_allocated_bytes"],
            "one_rank_param_bytes": ZeroInfinityEngine(run, "cpu").shard_bytes()[
                "param_shard_bytes"],
            "layout_param_bytes": layout.shard_bytes()["param_shard_bytes"],
            # one sequence's cache in this rank's layout (a recurrent family's
            # inner channels its own), the len leaf included
            "cache_bytes_per_seq": kvcache.sequence_kv_bytes(cfg, cap, layout.bundle.cache_defs),
            "data_split_leaves": [keystr(p) for p in pt.tree_paths(layout.splits["param"])
                                  if pt.tree_get(layout.splits["param"], p) is not None],
            "prefill_s": t["prefill_s"], "decode_s": t["decode_s"],
            **{k: out["mesh"][k] for k in ("cache_seq_split", "local_cache_len",
                                            "model_gather_bytes_per_step")},
            "ttft_p50_s": out["latency"]["ttft"]["p50"],
            "ttft_p99_s": out["latency"]["ttft"]["p99"],
            "decode_token_p50_s": out["latency"]["decode_token"]["p50"]}


def check_serve_ranks(tag: str, recs: list, one: dict, cfg, rows: dict = None) -> dict:
    """The checks of a serving run on ranks (``serve_rank``'s records)
    against the one-rank run ``one`` of the same argv (``launch.serve``'s
    output, or None where no card holds the model: then every sequence
    finished is what is held): every sequence's tokens equal (``rows``'
    where given: a one-rank run whose forwards hold as many rows as each
    rank's, see ``nccl_check``), each rank's param bytes 1/n of the
    one-rank run's (that rank's layout's; their sum the whole), the ``kv``
    bytes summed over the ranks equal, every flash and tiled-matmul launch
    of each rank on the tensor cores, as at one rank; each rank's peak
    allocated memory and the decode step's time printed."""
    n, r0 = len(recs), recs[0]
    steps = max(r0["steps"], 1)
    rec = {"run": tag, "argv": r0["argv"], "ranks": n, "backend": r0["backend"],
           "wall_s": [r["wall_s"] for r in recs], "steps": r0["steps"],
           "admissions": r0["admissions"], "admissions_ranks": r0["admissions_ranks"],
           "kv": {k: r0["kv"][k] for k in SERVE_KV},
           "kv_ranks": [{k: kr[k] for k in SERVE_KV} for kr in r0["kv_ranks"]],
           "param_shard_bytes": r0["param_shard_bytes"],
           "one_rank_param_bytes": r0["one_rank_param_bytes"],
           "peak_allocated_gb": [b / 1e9 for b in r0["peak_allocated_bytes"]],
           "decode_step_ms": r0["decode_s"] / steps * 1e3,
           "prefill_wave_ms": r0["prefill_s"] / -(-len(r0["generated"]) // r0["slots"]) * 1e3,
           "ttft_p50_s": r0["ttft_p50_s"], "ttft_p99_s": r0["ttft_p99_s"],
           "decode_token_p50_s": r0["decode_token_p50_s"],
           "launches_per_rank": [r["launches"] for r in recs]}
    if one is not None:
        ot = one["timings"]
        rec.update({"one_rank_kv": {k: one["kv"][k] for k in SERVE_KV},
                    "one_rank_steps": one["steps"], "one_rank_admissions": one["admissions"],
                    "one_rank_decode_step_ms": ot["decode_s"] / max(one["steps"], 1) * 1e3})
    say(f"{tag}:", json.dumps(rec))
    for r in recs:
        if not all(r["done"]) or any(len(g) != len(recs[0]["generated"][0]) for g in r["generated"]):
            raise SystemExit(f"FAIL {tag}: rank {r['rank']}: not every sequence finished")
        want = (rows or one or {}).get("generated")
        if want is not None and r["generated"] != want:
            diff = [s for s, (a, b) in enumerate(zip(r["generated"], want)) if a != b]
            raise SystemExit(f"FAIL {tag}: rank {r['rank']}'s sequences {diff} differ from "
                             "the one-rank run's tokens")
        whole, mine = r["one_rank_param_bytes"], r["param_shard_bytes"][r["rank"]]
        if not (n * mine == whole == sum(r["param_shard_bytes"])
                and mine == r["layout_param_bytes"]):
            raise SystemExit(f"FAIL {tag}: rank {r['rank']} holds {mine} param bytes "
                             f"(all ranks {r['param_shard_bytes']}) of {whole}; want 1/{n}")
        check_main_path_routes(tag, r["launches"])
        for name in ("flash_attention", "tiled_matmul"):
            if cfg.family in MLP_FAMILIES or name == "flash_attention":
                if not r["launches"][f"{name}_wgmma"]:
                    raise SystemExit(f"FAIL {tag}: rank {r['rank']} launched no {name}")
    if one is not None:
        if rec["kv"] != rec["one_rank_kv"] or r0["admissions"] != one["admissions"]:
            raise SystemExit(f"FAIL {tag}: kv bytes summed over the ranks {rec['kv']}, "
                             f"{r0['admissions']} admissions; the one-rank run "
                             f"{rec['one_rank_kv']}, {one['admissions']}")
    return rec


def phase_serve_dp2(recs, one: dict, host_launches: dict) -> tuple:
    """The "serve" part of the ranks' one spawn: ``launch.serve --data-mesh
    2`` on full smollm-135m at the serve host cell's sizes but 8 new tokens
    (``TP_SERVE_ARGV``: 8 sequences, 4 slots, 2 a rank, host tier, prompt
    512), held by ``check_serve_ranks`` against ``one``, the one-rank run of
    that argv ("tp serve one rank"): the same tokens, half the param bytes
    a rank, the same KV bytes summed; flash and the tiled matmul on wgmma on
    each rank as in phase 5 (``host_launches``)."""
    parts = _part(recs, "serve")
    rec = check_serve_ranks("serve dp2", parts, one, configs.get("smollm-135m"))
    for name in ("flash_attention", "tiled_matmul"):
        if not host_launches[f"{name}_wgmma"] or host_launches[f"{name}_simt"]:
            raise SystemExit(f"FAIL serve dp2: phase 5 launched {name} off wgmma")
    return rec, _sum_launches(parts)


def nccl_check(parts=("train", "serve", "tp")) -> int:
    """``chip_smoke.py --nccl-check [train|serve|tp]``, on a machine with
    four cards: the NCCL branch of the transport rule (each rank a card of
    its own). "train": the one-rank layered run (phase 9) on card 0, then
    "zero3 dp4 nccl train" (``phase_zero3_dp_train`` on 4 ranks,
    cuda:0-3), the one-rank "plan train" and "gspmd dp4 nccl train";
    "serve": llava at 8 layers on card 0 and on 4 ranks ("vlm serve dp4
    nccl", the same tokens), then at full depth, which no one card holds,
    on the 4 ranks alone ("vlm serve full dp4 nccl"); "tp": llava under
    tensor parallelism over the four ranks (``--model-mesh 4``), at 2
    layers trained against card 0's one-rank run ("vlm tp4 nccl train")
    and at full depth served ("vlm serve full tp4 nccl", each rank a
    quarter of every split leaf and no layer gathered). All three without
    an argument. Not part of the one-card run."""
    if torch.cuda.device_count() < 4:
        print(f"nccl check: {torch.cuda.device_count()} cards; it needs 4")
        return 1
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    launches = glaunches = None
    if "train" in parts:
        dp1, _ = phase_train_main()
        rec, launches, _ = phase_zero3_dp_train(dp1, 4, "zero3 dp4 nccl train")
        # one rank on card 0 plans for one device (detection counts the four)
        plan1, _ = phase_plan_train("plan train", ["--hw-devices", "1"])
        grec, glaunches, _ = phase_gspmd_dp_train(plan1, 4, "gspmd dp4 nccl train")
        for r in (rec, grec):
            if r["transport"]["backend"] != "nccl":
                raise SystemExit(f"FAIL nccl check: the ranks ran {r['transport']}")
    if "serve" in parts:
        # each of the 4 ranks serves 1 of the 4 slots, so its forwards hold
        # one row where one rank's hold four; the attention projections and
        # the logits are cuBLAS products, whose kernel and summation order
        # follow the row count. The ranks' tokens are held to a one-rank run
        # of one slot (one row a forward, as theirs); the KV bytes and
        # admissions to the run of the same argv, whose tokens are printed
        # beside (the sequences the row count alone moves)
        argv = VLM_SERVE_ARGV + ["--layers", str(VLM_SERVE_LAYERS)]
        one, _, _ = run_serve(argv)
        row_argv = list(argv)
        row_argv[row_argv.index("--kv-slots") + 1] = "1"
        rows, _, _ = run_serve(row_argv)
        torch.cuda.empty_cache()
        cut = configs.with_layers(configs.get(VLM_ARCH), VLM_SERVE_LAYERS)
        recs = run_ranks("vlm_serve", 900, 4)
        say("vlm serve dp4 nccl tokens:", json.dumps({
            "one_rank_4_vs_1_slots_differ": [s for s, (a, b) in enumerate(
                zip(one["generated"], rows["generated"])) if a != b],
            "ranks_vs_one_rank_4_slots_differ": [s for s, (a, b) in enumerate(
                zip(recs[0]["generated"], one["generated"])) if a != b]}))
        vrec = check_serve_ranks("vlm serve dp4 nccl", recs, one, cut, rows=rows)
        frec = check_serve_ranks("vlm serve full dp4 nccl",
                                 run_ranks("vlm_serve_full", 900, 4), None,
                                 configs.get(VLM_ARCH))
        for r in (vrec, frec):
            if r["backend"] != "nccl":
                raise SystemExit(f"FAIL nccl check: {r['run']} ran {r['backend']}")
        say("vlm serve full dp4 nccl peak:", json.dumps({
            "peak_allocated_gb": frec["peak_allocated_gb"], "card_gb": 80,
            "param_shard_gb": [b / 1e9 for b in frec["param_shard_bytes"]],
            "one_rank_param_gb": frec["one_rank_param_bytes"] / 1e9}))
    tlaunches = None
    if "tp" in parts:
        # llava under tensor parallelism on the four cards: at 2 layers
        # trained against the one-rank run of the same argv on card 0, then
        # served at full depth (no card holds it), a quarter of every split
        # leaf a rank and no layer gathered (one data rank)
        dp1, _ = phase_plan_train("vlm plan train", ["--hw-devices", "1"], arch=VLM_ARCH,
                                  batch=1, seq=4096, layers=VLM_TRAIN_LAYERS)
        torch.cuda.empty_cache()
        trec, tlaunches = phase_tp_train(run_ranks("vlm_tp_train", 900, 4), dp1,
                                         "vlm tp4 nccl train", VLM_TP4_BYTES[VLM_TRAIN_LAYERS])
        frec = check_tp_serve_full(run_ranks("vlm_serve_full_tp", 900, 4))
        for r in (trec["transport"]["backend"], frec["backend"]):
            if r != "nccl":
                raise SystemExit(f"FAIL nccl check: the tp ranks ran {r}")
    say("nccl check:", json.dumps({"ok": True, "cards": torch.cuda.device_count(),
                                   "launches": launches, "gspmd_launches": glaunches,
                                   "tp_launches": tlaunches}))
    return 0


def check_tp_serve_full(recs: list) -> dict:
    """"vlm serve full tp4 nccl": llava-next-34b at 60 layers served by
    ``launch.serve --model-mesh 4`` on four cards (``serve_rank``): every
    sequence finished, the same tokens on every rank, each rank's param
    bytes exactly ``VLM_TP4_BYTES[0]`` and its layout's, no param gathered
    over the data axis (one data rank: the serve view is the rank's own
    shards), each rank's flash and tiled-matmul launches on the tensor
    cores; the decode step, prefill wave, TTFT and peak allocated memory a
    rank printed."""
    tag, r0 = "vlm serve full tp4 nccl", recs[0]
    steps = max(r0["steps"], 1)
    rec = {"run": tag, "argv": r0["argv"], "ranks": len(recs), "backend": r0["backend"],
           "param_shard_bytes": r0["param_shard_bytes"],
           "want_param_shard_bytes": VLM_TP4_BYTES[0],
           "one_rank_param_bytes": r0["one_rank_param_bytes"],
           "kv": {k: r0["kv"][k] for k in SERVE_KV},
           "kv_ranks": [{k: kr[k] for k in SERVE_KV} for kr in r0["kv_ranks"]],
           "decode_step_ms": r0["decode_s"] / steps * 1e3,
           "prefill_wave_ms": r0["prefill_s"] / -(-len(r0["generated"]) // r0["slots"]) * 1e3,
           "ttft_p50_s": r0["ttft_p50_s"], "ttft_p99_s": r0["ttft_p99_s"],
           "peak_allocated_gb": [b / 1e9 for b in r0["peak_allocated_bytes"]], "card_gb": 80,
           "launches_per_rank": [r["launches"] for r in recs]}
    say(f"{tag}:", json.dumps(rec))
    for r in recs:
        if not all(r["done"]) or r["generated"] != r0["generated"]:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']}: not every sequence finished, or "
                             "its tokens differ from rank 0's")
        mine = r["param_shard_bytes"][r["rank"]]
        if not mine == VLM_TP4_BYTES[0] == r["layout_param_bytes"]:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']} holds {mine} param bytes; "
                             f"want {VLM_TP4_BYTES[0]}")
        if r["data_split_leaves"]:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']} gathers {r['data_split_leaves']} "
                             "over the data axis")
    _check_tp_ranks(tag, recs)
    return rec


# ---------------------------------------------------------------------------
# the GSPMD engine on data-parallel ranks: two sharing the one card (gloo)
# ---------------------------------------------------------------------------

# the GSPMD step's dp-2 placements (ZeRO-3: every leaf split over the
# ranks), held against the one-rank CPU side of phase 11's in-graph run
GSPMD_DP2_PLACEMENTS = ("in_graph", "off_graph")
GSPMD_NUMERICS_KEY = ("smollm-135m", (("n_layers", 2),), 4, 256, 2)


def _gspmd_dp2_record() -> str:
    """Where rank 0 of "gspmd dp2 numerics" saves the gathered params and
    masters (too large for a JSON line)."""
    return os.path.join(ROOT, "build", "chip_smoke_gspmd_dp2_numerics.pt")


def gspmd_dp2_numerics_rank() -> dict:
    """(a rank) Phase 11's model, weights and global batches (full-width
    smollm-135m cut to 2 layers, 4 x 256, 2 steps) through the GSPMD step
    at ZeRO-3 on 2 ranks on the card, each from its shards of the global
    state (``bridge.shard_gspmd_state``) on its rows of each batch, in
    ``GSPMD_DP2_PLACEMENTS``; the params and f32 masters gathered over the
    ranks after the last step, which rank 0 saves for the main process."""
    mesh = mesh_mod.make_local_mesh(2, 1, "cuda")
    rank, dev = mesh.rank, mesh.device
    arch, cut, B, S, steps = GSPMD_NUMERICS_KEY
    cfg = dataclasses.replace(configs.get(arch), **dict(cut))
    params0 = init_params(cfg)
    ops.reset_launch_counts()
    runs, unsplit = {}, {}
    for placement in GSPMD_DP2_PLACEMENTS:
        param, grad, opt, remat = GSPMD_PLACEMENTS[placement]
        nvme = os.path.join(ROOT, "build", f"chip_smoke_gspmd_dp2_{placement}")
        shutil.rmtree(os.path.join(nvme, f"rank{rank}"), ignore_errors=True)
        run = RunConfig(model=cfg, parallel=make_parallel("pjit", remat=remat, zero_stage=3),
                        offload=make_offload(param_tier=param, grad_tier=grad, opt_tier=opt,
                                             nvme_dir=nvme),
                        train=TrainConfig(lr=3e-3, steps=steps, seed=SEED))
        ex = InfinityExecutor(run, dev, mesh=mesh)
        eng = ex.engine
        full = {"params": params0}
        if not run.opt_offgraph:
            full["opt"] = adam.init_state(params0)
        state = ex.reseed(eng.place_state(bridge.shard_gspmd_state(full, run, rank, 2)))
        stream = SyntheticStream(ex.input_specs(ShapeConfig("n", S, B, "train")),
                                 cfg.vocab_size, seed=SEED)
        step = ex.make_train_step()
        traj = []
        for i in range(steps):
            batch = {k: torch.from_numpy(a).to(dev)
                     for k, a in rank_batch(stream.batch_at(i), rank, 2).items()}
            state, m = step(state, batch)
            traj.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        if ex.offgraph:  # the rank's opt shards from the store, shaped as its params'
            named = _store_masters(ex)
            masters: dict = {}
            for path in pt.tree_paths(state["params"]):
                like = pt.tree_get(state["params"], path)
                pt.tree_set(masters, path, named[f"rank{rank}/{keystr(path)}"]
                            .reshape(like.shape).to(dev))
        else:
            masters = state["opt"].master
        whole = [torch.cat([t.detach().float().cpu().reshape(-1)
                            for t in pt.tree_leaves(eng.respec(tree, cls, None))])
                 for tree, cls in ((state["params"], "param"), (masters, "opt"))]
        runs[placement] = (traj, *whole)
        unsplit = {cls: eng.unsplit_leaves(cls) for cls in ("param", "grad", "opt")}
        ex.close()
    if rank == 0:
        torch.save(runs, _gspmd_dp2_record())
    gspmd_dp2_moe_case(mesh)
    return {"rank": rank, "launches": ops.launch_counts(), "transport": mesh.transport(),
            "unsplit_leaves": unsplit, "trajectories": {p: r[0] for p, r in runs.items()}}


def _gspmd_dp2_moe_record(rank: int) -> str:
    return os.path.join(ROOT, "build", f"chip_smoke_gspmd_dp2_moe.rank{rank}.pt")


def gspmd_dp2_moe_case(mesh) -> None:
    """(a rank) "moe numerics/gspmd"'s model, weights and global batches
    (granite-moe-1b-a400m at full width cut to 2 layers) through the GSPMD
    step at ZeRO-3 on 2 ranks on the card, each from its shards, on its
    rows; saves the rank's trajectory and routing plans, and rank 0 the
    params and f32 masters gathered over the ranks."""
    rank, dev = mesh.rank, mesh.device
    layers, B, S, steps = MOE_NUMERICS
    cfg = dataclasses.replace(configs.get(MOE_ARCH), n_layers=layers)
    run = RunConfig(model=cfg, parallel=make_parallel("pjit", remat="none", zero_stage=3),
                    offload=make_offload(nvme_dir=os.path.join(ROOT, "build",
                                                               "chip_smoke_gspmd_dp2_moe")),
                    train=TrainConfig(lr=3e-3, steps=steps, seed=SEED))
    params0 = init_params(cfg)
    ex = InfinityExecutor(run, dev, mesh=mesh)
    eng = ex.engine
    full = {"params": params0, "opt": adam.init_state(params0)}
    state = ex.reseed(eng.place_state(bridge.shard_gspmd_state(full, run, rank, 2)))
    stream = SyntheticStream(ex.input_specs(ShapeConfig("n", S, B, "train")),
                             cfg.vocab_size, seed=SEED)
    step = ex.make_train_step()
    traj = []
    with RoutingRecorder() as rr:
        for i in range(steps):
            batch = {k: torch.from_numpy(a).to(dev)
                     for k, a in rank_batch(stream.batch_at(i), rank, 2).items()}
            state, m = step(state, batch)
            traj.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr",
                                                  "moe_dropped_token_fraction")})
            traj[-1]["moe_expert_load"] = m["moe_expert_load"].double().tolist()
    params = eng.respec(state["params"], "param", None)
    masters = eng.respec(state["opt"].master, "opt", None)
    out = {"traj": traj, "plans": rr.plans}
    if rank == 0:
        out["groups"] = _moe_param_groups(None, None, "gspmd", params=params)
        out["masters"] = {keystr(p): t.detach().float().cpu()
                          for p, t in zip(pt.tree_paths(masters), pt.tree_leaves(masters))}
    ex.close()
    torch.save(out, _gspmd_dp2_moe_record(rank))


def phase_gspmd_dp2_numerics(recs=None) -> tuple:
    """Both ranks' ``gspmd_dp2_numerics_rank``, each placement's gathered
    params and masters and its trajectory (the same on both ranks: loss
    and grad norm are summed over them) held against phase 11's kept
    one-rank CPU run by its bounds; the launches on the tensor cores."""
    recs = _part(recs, "gspmd_numerics")
    gathered = torch.load(_gspmd_dp2_record(), weights_only=False)
    out = {}
    for placement, card in gathered.items():
        if recs[1]["trajectories"][placement] != card[0]:
            raise SystemExit(f"FAIL gspmd dp2 numerics ({placement}): the ranks report "
                             f"{recs[1]['trajectories'][placement]} and {card[0]}")
        rec = {"placement": placement, "tiers_param_grad_opt_remat": GSPMD_PLACEMENTS[placement],
               "ranks": 2, "zero_stage": 3, "cpu_side": "one rank, in_graph, kept",
               "unsplit_leaves": recs[0]["unsplit_leaves"]}
        out[placement] = hold_card_to_cpu("gspmd dp2 numerics", placement,
                                          CPU_RUNS[GSPMD_NUMERICS_KEY].result()[0], card,
                                          rec)
    ranks = [torch.load(_gspmd_dp2_moe_record(r), weights_only=False) for r in range(2)]
    if ranks[0]["traj"] != ranks[1]["traj"]:
        raise SystemExit(f"FAIL gspmd dp2 numerics (moe): the ranks report {ranks[0]['traj']} "
                         f"and {ranks[1]['traj']}")
    plans = [torch.cat([r["plans"][i] for r in ranks]) for i in range(len(ranks[0]["plans"]))]
    cfg = dataclasses.replace(configs.get(MOE_ARCH), n_layers=MOE_NUMERICS[0])
    card = (ranks[0]["traj"], *ranks[0]["groups"], ranks[0]["masters"], plans)
    out["moe"] = hold_moe_to_cpu("gspmd dp2 numerics", cfg, MOE_CPU_RUNS["gspmd"], card,
                                 {"kind": "gspmd", "arch": MOE_ARCH, "ranks": 2, "zero_stage": 3,
                                  "cpu_side": "one rank, kept (moe numerics/gspmd)"})
    for r in recs:
        say("gspmd dp2 numerics launches:", json.dumps({
            "rank": r["rank"], "launches": r["launches"], "transport": r["transport"]}))
        check_main_path_routes("gspmd dp2 numerics", r["launches"])
    return out, _sum_launches(recs)


def gspmd_train_rank(arch: str = "smollm-135m", layers: int = 0,
                     steps: int = DP_TRAIN_STEPS) -> dict:
    """(a rank) ``launch.train --plan auto --hw-devices N`` (N the launch's
    world size) on ``arch`` at full width (its depth cut to ``layers``; 0:
    whole), ``steps`` steps of 8 x 512 (8 / N x 512 a rank), tracer on:
    the plan it chose, this rank's state bytes and their sums, the
    one-rank bytes of the same run, the leaves that split over no rank,
    its step metrics (MoE: the routing statistics), launches, peak
    allocated memory and transport."""
    n = int(os.environ["WORLD_SIZE"])
    nvme = os.path.join(ROOT, "build", f"chip_smoke_gspmd_dp{n}_{arch}")
    argv = _depth(arch, layers) + [
        "--plan", "auto", "--hw-devices", str(n),
        "--batch", "8", "--seq", "512", "--steps", str(steps), "--lr", "3e-3",
        "--nvme-dir", nvme, "--ckpt-every", "0", "--log-every", "1"]
    trace.enable()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.train(train.build_argparser().parse_args(argv), argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trace.disable()
    trace.clear()
    mesh, plan, run = hist["mesh"], hist["plan"], hist["run"]
    # the engine's layout on this rank (no collective: a CPU engine on the
    # rank's mesh), and the same run's one-rank bytes
    layout = ZeroInfinityEngine(run, "cpu", mesh=dataclasses.replace(mesh, device="cpu"))
    keys = [f"{c}_shard_bytes" for c in ("param", "grad", "opt")]

    def fracs(m):
        w = max(m["trace_wall_s"], 1e-12)
        return {"compute_frac": m["trace_compute_s"] / w,
                "io_wait_frac": m["trace_io_wait_s"] / w,
                "io_wait_collective_frac": m.get("trace_io_wait_collective_s", 0.0) / w,
                "other_frac": m["trace_other_s"] / w}

    return {"rank": mesh.rank, "argv": " ".join(argv), "wall_s": wall,
            "plan": plan.summary(), "engine": plan.engine, "tiers": plan.tiers,
            "remat": plan.remat, "zero_stage": run.parallel.zero_stage,
            "launches": ops.launch_counts(), "transport": mesh.transport(),
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "one_rank_bytes": ZeroInfinityEngine(run, "cpu").shard_bytes(),
            "layout_bytes": layout.shard_bytes(),
            "unsplit_leaves": {c: layout.unsplit_leaves(c) for c in ("param", "grad", "opt")},
            "steps": [{"step": m["step"], "loss": m["loss"], "grad_norm": m["grad_norm"],
                       "step_s": m["step_time"], "tokens_per_s": m["tokens_per_s"], **fracs(m),
                       **{k: m[k] for k in keys}, **{f"{k}_all_ranks": m[f"{k}_all_ranks"]
                                                     for k in keys},
                       **{f"plan_{k}": m[f"plan_{k}"] for k in keys},
                       **{k: m[k] for k in ("moe_dropped_token_fraction", "moe_expert_load")
                          if k in m}}
                      for m in hist["metrics"]]}


def phase_gspmd_dp_train(dp1: dict, n: int = 2, tag: str = "gspmd dp2 train",
                         mode: str = "gspmd_train", recs=None) -> tuple:
    """``n`` ranks' ``gspmd_train_rank``: the plan the GSPMD step with
    params on the device; the losses finite, falling and those of the
    one-rank "plan train" run (``dp1``: the same seed and global batches)
    by ``TRAIN_TOL``; each rank's param, grad and opt bytes an n-th of the
    one-rank run's and their sum equal to it, where every leaf splits
    (the leaves that do not are named); the launches of a step on every
    rank, all on the tensor cores. ``mode`` "gspmd_train+moe" also trains
    MoE in the same spawn (``phase_gspmd_moe_dp_train`` reads it): the
    ranks' records come back third."""
    cfg = configs.get("smollm-135m")
    recs = _part(recs, mode, n)
    rec = check_gspmd_dp_train(tag, cfg, DP_TRAIN_STEPS, dp1, recs)
    return rec, _sum_launches(recs), recs


def phase_gspmd_moe_dp_train(dp1: dict, recs: list, tag: str = "gspmd moe dp2 train") -> tuple:
    """The MoE part of the ranks' "gspmd_train+moe" spawn: ``launch.train
    --plan auto --hw-devices 2`` on granite-moe-1b-a400m at full width cut
    to ``MOE_LAYERED_LAYERS``, ``MOE_TRAIN_STEPS`` steps of 8 x 512, by
    ``check_gspmd_dp_train``: held against the one-rank "moe layered" run
    (``dp1``: the same weights, seed and global batches through the
    explicit engine's waves, which sum to the all-resident step), the
    routing statistics equal on both ranks."""
    parts = [r["moe"] for r in recs]
    cfg = configs.with_layers(configs.get(MOE_ARCH), MOE_LAYERED_LAYERS)
    rec = check_gspmd_dp_train(tag, cfg, MOE_TRAIN_STEPS, dp1, parts)
    for i in range(MOE_TRAIN_STEPS):
        ms = [r["steps"][i] for r in parts]
        for key in ("moe_dropped_token_fraction", "moe_expert_load"):
            if any(m[key] != ms[0][key] for m in ms):
                raise SystemExit(f"FAIL {tag}: the ranks report {key} {[m[key] for m in ms]}")
    return rec, _sum_launches(parts)


def check_gspmd_dp_train(tag: str, cfg, steps: int, dp1: dict, recs: list) -> dict:
    """The checks of a GSPMD dp train run (``gspmd_train_rank``'s records
    of each rank) on ``cfg`` against its one-rank run ``dp1``."""
    L, n = cfg.n_layers, len(recs)
    for r in recs:
        for m in r["steps"]:
            say(f"{tag} step:", json.dumps({"rank": r["rank"], **m}))
    r0 = recs[0]
    rec = {"argv": r0["argv"], "plan": r0["plan"], "zero_stage": r0["zero_stage"],
           "transport": r0["transport"], "wall_s": [r["wall_s"] for r in recs],
           "peak_allocated_gb": [r["peak_allocated_gb"] for r in recs],
           "dp1_peak_allocated_gb": dp1.get("peak_allocated_gb"),
           "launches_per_rank": [r["launches"] for r in recs],
           "losses": [m["loss"] for m in r0["steps"]], "dp1_losses": dp1["losses"][:steps],
           "bytes_per_rank": {k: r0["steps"][-1][k] for k in r0["one_rank_bytes"]},
           "bytes_all_ranks": {k: r0["steps"][-1][f"{k}_all_ranks"]
                               for k in r0["one_rank_bytes"]},
           "plan_bytes_per_device": {k: r0["steps"][-1][f"plan_{k}"]
                                     for k in r0["one_rank_bytes"]},
           "one_rank_bytes": r0["one_rank_bytes"], "unsplit_leaves": r0["unsplit_leaves"],
           "median_step_s_after_first": statistics.median(m["step_s"] for m in r0["steps"][1:]),
           "dp1_median_step_s_after_first": dp1["median_step_s_after_first"]}
    rec["median_tokens_per_s_after_first"] = 8 * 512 / rec["median_step_s_after_first"]
    say(f"{tag}:", json.dumps(rec))
    if r0["engine"] != "pjit" or set(r0["tiers"].values()) != {"device"}:
        raise SystemExit(f"FAIL {tag}: the planner gave {r0['plan']}; this phase runs the "
                         "GSPMD step with every state on the device")
    losses = rec["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL {tag}: losses not finite or not falling: {losses}")
    for got, want in zip(losses, rec["dp1_losses"]):
        if not abs(got - want) <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(want):
            raise SystemExit(f"FAIL {tag}: loss {got} vs the one-rank run's {want}")
    for r in recs:
        for cls, names in r["unsplit_leaves"].items():
            if names:
                raise SystemExit(f"FAIL {tag}: rank {r['rank']}'s {cls} leaves {names} split "
                                 f"over no rank (d_model {cfg.d_model})")
        for m in r["steps"]:
            for k, whole in r["one_rank_bytes"].items():
                if not (n * m[k] == whole == m[f"{k}_all_ranks"]
                        and m[k] == r["layout_bytes"][k]):
                    raise SystemExit(f"FAIL {tag}: rank {r['rank']} step {m['step']} {k} "
                                     f"{m[k]} (all ranks {m[f'{k}_all_ranks']}), the one-rank "
                                     f"run's {whole}")
        fwd = 2 if r["remat"] == "full" else 1
        mlp = mlp_products(cfg) if cfg.family in MLP_FAMILIES else 0  # MoE: einsums
        want = {"flash_attention": fwd * L * steps, "flash_attention_bwd": L * steps,
                "tiled_matmul": (fwd + 2) * mlp * steps,
                "fused_adam": len(pt.tree_paths(registry.build(cfg).defs)) * steps}
        for name, count in want.items():
            if r["launches"][name] < count:
                raise SystemExit(f"FAIL {tag}: rank {r['rank']} launched {name} "
                                 f"{r['launches'][name]} < {count}")
        check_main_path_routes(tag, r["launches"])
    return rec


# ---------------------------------------------------------------------------
# tensor and context parallelism: model ranks sharing the one card (gloo)
# ---------------------------------------------------------------------------

# the model axis' jobs: context parallelism (smollm's 9 heads do not split
# over 2) in the two-rank spawn (DP_PARTS), tensor parallelism over 3 (3
# heads, 1 KV head, 512 MLP columns and 16,384 vocab rows a rank) in a
# spawn of three ranks of its own
TP3_PARTS = ("tp_numerics", "tp_train", "tp_serve")
# full smollm-135m's param bytes a rank: at (1, 3) every leaf but the f32
# norms a third; at (1, 2) the attention weights and norms (53,224,704
# bytes) whole, the MLP and the vocab halved (of 269,100,288)
TP_BYTES = {3: 89_793_792, 2: 161_162_496}
TP_STRATEGY = {4: "tp", 3: "tp", 2: "cp"}
# llava-next-34b on four NCCL cards under tensor parallelism (--nccl-check
# tp): its 60 layers' param bytes a rank, of 68,823,609,344, and its 2
# layers' (for "vlm tp4 nccl train"), of 4,110,561,280
VLM_TP4_BYTES = {0: 17_208_504_320, VLM_TRAIN_LAYERS: 1_027_747_840}
TP_TRAIN_STEPS = 3
# a MoE run's routing statistics (launch.train's step metrics)
MOE_STATS = ("moe_dropped_token_fraction", "moe_expert_load")
# full granite-moe-1b-a400m's param bytes a rank under tensor parallelism
# at (1, 2), of 2,675,118,080: the experts, vocab, heads and KV heads halved
MOE_TP_BYTES = {2: 1_339_232_256}
# flash at context parallelism's shapes: "cp train"'s rank 0 (its 256
# queries on their 256 keys) and rank 1 (on all 512), causal
FLASH_CP = [(8, 9, 3, 256, 256, 64), (8, 9, 3, 256, 512, 64)]
# flash at tensor parallelism's shapes, (shape, window): "tp train"'s
# (smollm on 3 model ranks: 3 heads, 1 KV head, 8 x 512), "vlm tp4 nccl
# train"'s (llava on 4: 14 heads, 2 KV heads of 128, 1 x 4096), "moe tp
# train"'s (granite on 2: 8 heads, 4 KV heads, 8 x 512) and "hybrid tp
# train"'s (recurrentgemma on 2: 8 heads on its one KV head of 256, 1 x
# 4096, window 2048), causal; then "encdec tp train"'s (seamless on 2: 8
# of 16 heads, 8 x 2048 frames): the encoder's and the cross-attention's
# (512 decoder tokens on 2048 frames), not causal, and the decoder's,
# causal. (shape, window, causal)
FLASH_TP = [((8, 3, 1, 512, 512, 64), 0, True), ((1, 14, 2, 4096, 4096, 128), 0, True),
            ((8, 8, 4, 512, 512, 64), 0, True), ((1, 8, 1, 4096, 4096, 256), 2048, True),
            ((8, 8, 8, 2048, 2048, 64), 0, False), ((8, 8, 8, 512, 2048, 64), 0, False),
            ((8, 8, 8, 512, 512, 64), 0, True)]


def mlp_shard_shapes(T: int, d: int, f: int) -> list:
    """The MLP's products of one layer at ``T`` tokens, width ``d`` and a
    rank's ``f`` columns, as ``TILED_TRAIN`` lists them: x @ W_in|gate
    (column shard) and h @ W_out (row shard), then dX = dY @ W^T and dW =
    X^T @ dY of each on transposed views."""
    return [(T, d, f, ""), (T, f, d, ""), (T, f, d, "w"), (d, T, f, "x"),
            (T, d, f, "w"), (f, T, d, "x")]


# the same runs' MLP products: smollm's 512 of 1536 columns a rank,
# llava's 5120 of 20480, recurrentgemma's GeGLU 6144 of 12,288 (K <=
# 7168: K * 2^-24 < 2^-11, "tiled_matmul_k4096") and seamless's 2048 of
# 4096 at 16384 frames (its dW's K = 16384: "tiled_matmul_k20480")
TILED_TP = (mlp_shard_shapes(4096, 576, 512) + mlp_shard_shapes(4096, 7168, 5120)
            + mlp_shard_shapes(4096, 4096, 6144) + mlp_shard_shapes(16384, 1024, 2048))
# the products of TILED_TP timed: each run's forward column and row shards
TILED_TP_TIMED = [c for c in TILED_TP if c[3] == ""]
# "tp serve"'s argv: the serve host cell's sizes at 8 new tokens (each
# decode step on three gloo ranks takes ~6x one rank's), held to a one-rank
# run of the same argv
TP_SERVE_ARGV = SERVE_ARGV[:-1] + ["8"]
# phase 4's CPU logits, kept for "tp serve"'s teacher-forced check
E2E_CPU: dict = {}
# the recurrent families on the model axis (the two-rank spawn): mamba2
# under context parallelism (no attention heads: "auto" answers "cp"; each
# rank 16 of its 32 SSD heads over the whole sequence), recurrentgemma
# under tensor parallelism (8 of 16 heads, 2048 of its 4096 LRU channels,
# 6144 of 12,288 MLP columns and half the vocab a rank). "ssm cp
# numerics" runs "recurrent numerics"' mamba2 (its key in CPU_RUNS). These
# phases are the ones cut for the run's time limit: "ssm cp train" and
# "hybrid tp train" take ``RECURRENT_TRAIN_STEPS``, not 3; the serving runs
# are "ssm serve"'s argv at 4 new tokens and full recurrentgemma at "hybrid
# serve"'s prompt, 3 sequences through 2 slots (two prefill waves of 2 x
# 2560, ~6 s each on two gloo ranks; the third sequence parked and
# admitted) and 4 new tokens
SSM_NUMERICS_KEY = (SSM_ARCH, (("n_layers", 2),), 4, 256, 2)
RECURRENT_TRAIN_STEPS = 2
SSM_SERVE_ARGV = ["--arch", SSM_ARCH, "--batch", "8", "--kv-slots", "4", "--kv-tier", "host",
                  "--prompt-len", "512", "--new-tokens", "4"]
HYBRID_SERVE_ARGV = ["--arch", HYBRID_ARCH, "--batch", "3", "--kv-slots", "2", "--kv-tier",
                     "host", "--prompt-len", "2560", "--new-tokens", "4"]
# the one-rank runs the recurrent model-axis serving phases are held to, by
# tag: "ssm serve" and "hybrid tp serve one rank" (``HYBRID_SERVE_ARGV``)
FAMILY_SERVE_ONE: dict = {}
# the encoder-decoder on the model axis (the two-rank spawn): seamless on
# (1, 2) under tensor parallelism ("auto": 8 of 16 heads, 2048 of 4096 MLP
# columns and half the vocab a rank) and context parallelism forced.
# "encdec tp / cp numerics" run "family numerics"' seamless (its key in
# CPU_RUNS: 2 x 256 frames, 64 decoder tokens a row);
# "encdec tp train" full seamless, 8 x 2048 frames, 2 steps; "encdec tp
# serve" full seamless, 3 sequences of 2048 frames through 2 slots (the
# third parks), 4 new tokens, held to a one-rank run of its argv;
# "encdec cp serve" full width cut to 4 + 4 layers (the run's time
# limit), 2 sequences in 2 slots, 4 new tokens: the capacity 512 + 4 and
# the 2048 frames split, each rank its range of both
ENCDEC_NUMERICS_KEY = (ENCDEC_ARCH, tuple(sorted(ENCDEC_NUMERICS_CUT.items())), 2, 256, 2)
ENCDEC_TP_SERVE_ARGV = ["--arch", ENCDEC_ARCH, "--batch", "3", "--kv-slots", "2", "--kv-tier",
                        "host", "--prompt-len", "2048", "--new-tokens", "4"]
ENCDEC_CP_SERVE_ARGV = ENCDEC_TP_SERVE_ARGV[:3] + ["2"] + ENCDEC_TP_SERVE_ARGV[4:]
ENCDEC_CP_SERVE_CUT = {"n_layers": 8, "n_enc_layers": 4, "n_dec_layers": 4}


def _tp_record(name: str) -> str:
    """Where rank 0 of a model-axis job saves what is too large for its
    JSON record."""
    return os.path.join(ROOT, "build", f"chip_smoke_{name}.pt")


def tp_numerics_rank(key=GSPMD_NUMERICS_KEY, name: str = "numerics",
                     strategy: str = "auto") -> dict:
    """(a rank) A numerics phase's model, weights and global batches
    (``key``, ``CPU_RUNS``' key: by default phase 11's full-width
    smollm-135m cut to 2 layers, 4 x 256, 2 steps) through the GSPMD step
    at ZeRO-3 on a (1, M) mesh of the launch's M ranks on the card under
    ``strategy`` (smollm's "auto": tensor parallelism at 3, context at 2),
    each from its shards of the global state on the whole batch; the
    params and f32 masters joined over the ranks after the last step, which
    rank 0 saves as ``name``."""
    M = int(os.environ["WORLD_SIZE"])
    mesh = mesh_mod.make_local_mesh(1, M, "cuda")
    rank, dev = mesh.rank, mesh.device
    arch, cut, B, S, steps = key
    cfg = dataclasses.replace(configs.get(arch), **dict(cut))
    params0 = init_params(cfg)
    run = RunConfig(model=cfg, parallel=make_parallel("pjit", remat="none", zero_stage=3,
                                                      attn_strategy=strategy),
                    offload=make_offload(nvme_dir=os.path.join(ROOT, "build", "chip_smoke_tp")),
                    train=TrainConfig(lr=3e-3, steps=steps, seed=SEED))
    ops.reset_launch_counts()
    ex = InfinityExecutor(run, dev, mesh=mesh)
    eng = ex.engine
    full = {"params": params0, "opt": adam.init_state(params0)}
    state = ex.reseed(eng.place_state(bridge.shard_gspmd_state(full, run, rank, 1, M)))
    stream = SyntheticStream(ex.input_specs(ShapeConfig("n", S, B, "train")),
                             cfg.vocab_size, seed=SEED)
    step = ex.make_train_step()
    traj = []
    for i in range(steps):
        batch = {k: torch.from_numpy(a).to(dev) for k, a in stream.batch_at(i).items()}
        state, m = step(state, batch)
        traj.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    whole = [torch.cat([t.detach().float().cpu().reshape(-1)
                        for t in pt.tree_leaves(eng.respec(tree, cls, None))])
             for tree, cls in ((state["params"], "param"), (state["opt"].master, "opt"))]
    if rank == 0:
        torch.save((traj, *whole), _tp_record(f"{name}_m{M}"))
    ex.close()
    return {"rank": rank, "launches": ops.launch_counts(), "transport": mesh.transport(),
            "strategy": eng.mp.strategy, "trajectory": traj,
            "param_shard_bytes": eng.shard_bytes()["param_shard_bytes"]}


def tp_train_rank(arch: str = "smollm-135m", layers: int = 0, batch: int = 8, seq: int = 512,
                  steps: int = TP_TRAIN_STEPS) -> dict:
    """(a rank) ``launch.train --engine pjit --model-mesh M`` (M the
    launch's world size) on ``arch`` at full width (its depth cut to
    ``layers``; 0: whole) at ZeRO-3, ``steps`` steps of ``batch`` x
    ``seq`` (each model rank the whole batch; under context parallelism
    its seq / M positions of every row): this rank's step metrics, state
    bytes, launches, peak allocated memory and transport."""
    M = int(os.environ["WORLD_SIZE"])
    argv = _depth(arch, layers) + [
        "--engine", "pjit", "--data-mesh", "1", "--model-mesh", str(M), "--zero-stage", "3",
        "--batch", str(batch), "--seq", str(seq), "--steps", str(steps), "--lr", "3e-3",
        "--ckpt-every", "0", "--log-every", "1",
        "--nvme-dir", os.path.join(ROOT, "build", f"chip_smoke_tp_train_m{M}")]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.train(train.build_argparser().parse_args(argv), argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mesh, run = hist["mesh"], hist["run"]
    keys = [f"{c}_shard_bytes" for c in ("param", "grad", "opt")]
    return {"rank": mesh.rank, "argv": " ".join(argv), "wall_s": wall, "tokens": batch * seq,
            "strategy": pt.choose_attn_strategy(run.model, mesh.axis_sizes(), run.parallel),
            "launches": ops.launch_counts(), "transport": mesh.transport(),
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "steps": [{"step": m["step"], "loss": m["loss"], "grad_norm": m["grad_norm"],
                       "step_s": m["step_time"], **{k: m[k] for k in keys},
                       **{f"{k}_all_ranks": m[f"{k}_all_ranks"] for k in keys},
                       **{k: m[k] for k in MOE_STATS if k in m}}
                      for m in hist["metrics"]]}


def forced_rank_logits(name: str) -> None:
    """(a rank) Phase 4's teacher-forced prefill and decode (full-width
    smollm-135m cut to 2 layers, the same weights and tokens) on the
    rank's shards of a (1, M) mesh, the cache laid out as ``launch.serve``
    lays out its slot cache (under context parallelism the rank's range of
    the 68 positions, ``kvcache.decode_positions``), the logits gathered over
    the model ranks where their vocab is split: rank 0 saves them as
    ``name``."""
    M = int(os.environ["WORLD_SIZE"])
    mesh = mesh_mod.make_local_mesh(1, M, "cuda")
    cfg = dataclasses.replace(configs.get("smollm-135m"), n_layers=2)
    eng = ZeroInfinityEngine(RunConfig(model=cfg, parallel=make_parallel("pjit", remat="none")),
                             mesh.device, mesh=mesh)
    whole = _to(init_params(cfg), mesh.device)
    view = eng.serve_params(eng.respec(whole, None, "param"))
    del whole
    rng = np.random.default_rng(SEED)
    B, S, n_dec = 2, 64, 4
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + n_dec),
                                         dtype=np.int32)).to(mesh.device)
    with torch.no_grad():
        lg, cache = eng.bundle.prefill(view, {"tokens": toks[:, :S]})
        cache, own, n, split = kvcache.decode_positions(cache, eng.mp, S + n_dec)
        cache = kvcache.grow_cache(cache, n - own, cfg.family)
        cache["len"] = torch.full((B,), S, dtype=torch.int32, device=mesh.device)
        lgs = [lg]
        for i in range(n_dec):
            lg, cache = eng.bundle.decode_step(view, cache, {"tokens": toks[:, S + i:S + i + 1]},
                                               **({"seq_split": True} if split else {}))
            lgs.append(lg)
    logits = torch.cat(lgs, dim=1).float()
    if cm.vocab_sharded(view["embed"], cfg, eng.mp):
        logits = mesh.all_gather(logits, 2, "model")
    if mesh.rank == 0:
        torch.save(logits.cpu(), _tp_record(name))


def tp_serve_rank() -> dict:
    """(a rank) ``serve_rank`` with ``TP_SERVE_ARGV`` on a (1, M) mesh
    (tensor parallelism), then ``forced_rank_logits``."""
    M = int(os.environ["WORLD_SIZE"])
    rec = serve_rank(TP_SERVE_ARGV + ["--model-mesh", str(M)], model=M)
    forced_rank_logits("serve_logits")
    return rec


def cp_serve_rank() -> dict:
    """(a rank) ``serve_rank`` with ``TP_SERVE_ARGV`` on a (1, 2) mesh:
    context parallelism (smollm's 9 heads over 2), then
    ``forced_rank_logits``."""
    M = int(os.environ["WORLD_SIZE"])
    rec = serve_rank(TP_SERVE_ARGV + ["--model-mesh", str(M)], model=M)
    forced_rank_logits("cp_serve_logits")
    return rec


def encdec_cp_serve_cfg():
    """Seamless at full width cut to ``ENCDEC_CP_SERVE_CUT``: what "encdec
    cp serve" and its one-rank run serve (``launch.serve``'s ``--layers``
    cuts one stack, and an encoder-decoder has two)."""
    return dataclasses.replace(configs.get(ENCDEC_ARCH), **ENCDEC_CP_SERVE_CUT)


def encdec_cp_serve_rank() -> dict:
    """(a rank) ``serve_rank`` with ``ENCDEC_CP_SERVE_ARGV`` on a (1, M)
    mesh, ``encdec_cp_serve_cfg`` under context parallelism forced."""
    M = int(os.environ["WORLD_SIZE"])
    return serve_rank(ENCDEC_CP_SERVE_ARGV + ["--model-mesh", str(M)], model=M,
                      strategy="cp", cfg=encdec_cp_serve_cfg())


def phase_model_axis_kernels() -> dict:
    """The kernels at the model axis' per-rank shapes, bf16, against the
    plain version by ``TOL``, on the tensor cores: flash forward and
    backward at context parallelism's (``FLASH_CP``: 256 queries on 256
    and on 512 keys, causal, the mask aligned at the end; the 256-on-512
    shape timed beside the bound, the CUDA-core kernel, the plain version
    and SDPA, the end-aligned mask as a boolean one) and at tensor
    parallelism's (``FLASH_TP``, timed likewise), and the tiled matmul at
    tensor parallelism's MLP shards (``TILED_TP``; the forward products,
    ``TILED_TP_TIMED``, timed beside the bound, the CUDA-core kernel, the
    plain version and ``torch.matmul``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    bf16 = torch.bfloat16
    timed = [shape[4] > shape[3] for shape in FLASH_CP]  # the new shape: Sq < Sk
    fwd = [check_flash(shape, bf16, gen, t) for shape, t in zip(FLASH_CP, timed)]
    bwd = [check_flash_bwd(shape, bf16, gen, t) for shape, t in zip(FLASH_CP, timed)]
    windowed = {"flash_attention_window": [], "flash_attention_bwd_window": []}
    for shape, window, causal in FLASH_TP:
        fw, bw = (("flash_attention_window", "flash_attention_bwd_window") if window else
                  ("flash_attention", "flash_attention_bwd"))
        f = check_flash(shape, bf16, gen, True, window, name=fw, causal=causal)
        b = check_flash_bwd(shape, bf16, gen, True, window, name=bw, causal=causal)
        (windowed[fw] if window else fwd).append(f)
        (windowed[bw] if window else bwd).append(b)
    flash = fwd + bwd + windowed["flash_attention_window"] + windowed["flash_attention_bwd_window"]
    check_flash_routes(flash)
    tiled = [check_tiled_t(c, bf16, gen, timed=c in TILED_TP_TIMED) for c in TILED_TP]
    check_routes(tiled)
    for rec in flash + tiled:
        say("model axis kernel check:", json.dumps(rec))
    return {"flash_attention": fwd, "flash_attention_bwd": bwd, "tiled_matmul": tiled,
            **windowed}


def _check_tp_ranks(tag: str, recs: list, strategy: str = "",
                    kernels=("flash_attention", "tiled_matmul"), none=()) -> None:
    """Every rank ran the strategy of its model axis (``strategy``; by
    default smollm's: tensor parallelism at 3 and 4 ranks, context at 2),
    launched each of ``kernels`` (the routed ones all on the tensor cores)
    and none of ``none`` (MoE's experts are batched einsums: its runs
    launch no tiled matmul; mamba2's products are all einsums outside
    Pallas, as the reference's: its runs launch neither flash nor the
    tiled matmul)."""
    M = len(recs)
    strategy = strategy or TP_STRATEGY[M]
    for r in recs:
        launches = r["launches"]
        if r.get("strategy", strategy) != strategy:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']} ran {r['strategy']}")
        check_main_path_routes(tag, launches)
        for name in kernels:
            if not launches.get(f"{name}_wgmma", launches[name]):
                raise SystemExit(f"FAIL {tag}: rank {r['rank']} launched no {name}")
        for name in none:
            if launches[name]:
                raise SystemExit(f"FAIL {tag}: rank {r['rank']} launched {name} "
                                 f"{launches[name]} times; want none")


def phase_tp_numerics(recs: list, tag: str, key=GSPMD_NUMERICS_KEY, name: str = "numerics",
                      strategy: str = "", kernels=("flash_attention", "tiled_matmul"),
                      none=()) -> tuple:
    """The ranks' ``tp_numerics_rank`` of ``key``: the trajectory (one on
    every rank) and the joined params and masters held against the kept
    one-rank CPU run of ``key`` (phase 11's by default) by its bounds;
    each rank's param bytes and launches (``_check_tp_ranks``) printed."""
    M = len(recs)
    card = torch.load(_tp_record(f"{name}_m{M}"), weights_only=False)
    for r in recs:
        if r["trajectory"] != card[0]:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']} reports {r['trajectory']}, "
                             f"rank 0 {card[0]}")
    arch, cut = key[:2]
    rec = {"ranks": M, "mesh": [1, M], "strategy": recs[0]["strategy"], "zero_stage": 3,
           "arch": arch, "cut": dict(cut), "cpu_side": "one rank, in_graph, kept",
           "param_shard_bytes": [r["param_shard_bytes"] for r in recs],
           "launches_per_rank": [r["launches"] for r in recs]}
    out = hold_card_to_cpu(tag, f"{arch} {dict(cut)} on (1, {M})",
                           CPU_RUNS[key].result()[0], card, rec)
    _check_tp_ranks(tag, recs, strategy, kernels, none)
    return out, _sum_launches(recs)


def phase_tp_train(recs: list, dp1: dict, tag: str, want_bytes: int = 0,
                   strategy: str = "", kernels=("flash_attention", "tiled_matmul"),
                   none=()) -> tuple:
    """The ranks' ``tp_train_rank``: the losses (one on every rank) finite
    and those of the one-rank "plan train" run (``dp1``: the same seed and
    global batches) by ``TRAIN_TOL``; each rank's param bytes exactly
    ``want_bytes`` (default full smollm's ``TP_BYTES[M]``) every step; each
    rank's launches on the tensor cores; the step wall, tokens/s and peak
    allocated memory a rank."""
    M, r0 = len(recs), recs[0]
    want_bytes = want_bytes or TP_BYTES[M]
    for r in recs:
        for m in r["steps"]:
            say(f"{tag} step:", json.dumps({"rank": r["rank"], **m}))
    losses = [m["loss"] for m in r0["steps"]]
    rec = {"argv": r0["argv"], "strategy": r0["strategy"], "transport": r0["transport"],
           "losses": losses, "dp1_losses": dp1["losses"][:len(losses)],
           "param_shard_bytes": [r["steps"][-1]["param_shard_bytes"] for r in recs],
           "want_param_shard_bytes": want_bytes,
           "bytes_all_ranks": {k: r0["steps"][-1][f"{k}_all_ranks"]
                               for k in ("param_shard_bytes", "grad_shard_bytes",
                                         "opt_shard_bytes")},
           "wall_s": [r["wall_s"] for r in recs],
           "peak_allocated_gb": [r["peak_allocated_gb"] for r in recs],
           "median_step_s_after_first": statistics.median(m["step_s"] for m in r0["steps"][1:]),
           "dp1_median_step_s_after_first": dp1["median_step_s_after_first"],
           "launches_per_rank": [r["launches"] for r in recs]}
    rec["median_tokens_per_s_after_first"] = r0["tokens"] / rec["median_step_s_after_first"]
    say(f"{tag}:", json.dumps(rec))
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"FAIL {tag}: losses not finite: {losses}")
    for r in recs:
        if [m["loss"] for m in r["steps"]] != losses:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']}'s losses differ from rank 0's")
        for m in r["steps"]:
            if m["param_shard_bytes"] != want_bytes:
                raise SystemExit(f"FAIL {tag}: rank {r['rank']} holds {m['param_shard_bytes']} "
                                 f"param bytes; want {want_bytes}")
    for got, want in zip(losses, rec["dp1_losses"]):
        if not abs(got - want) <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(want):
            raise SystemExit(f"FAIL {tag}: loss {got} vs the one-rank run's {want}")
    _check_tp_ranks(tag, recs, strategy, kernels, none)
    return rec, _sum_launches(recs)


def phase_tp_serve(recs: list, one: dict) -> tuple:
    """The ranks' ``tp_serve_rank`` (full smollm-135m with
    ``TP_SERVE_ARGV`` on (1, 3)) against ``one``, the one-rank run of the
    same argv: every sequence finished, the same tokens on every rank and
    their share equal to the one rank's printed (the row-parallel products
    round apart from one rank's), each rank's param bytes exactly
    ``TP_BYTES[3]``, the ``kv`` bytes summed over the ranks the one rank's
    (the KV heads split), the teacher-forced logits at 2 layers held to phase
    4's CPU side by ``E2E_REL_TOL``, each rank's launches on the tensor
    cores; the decode step's time and peak allocated memory printed."""
    tag, M, r0, host_out = "tp serve", len(recs), recs[0], one
    lg = torch.load(_tp_record("serve_logits"), weights_only=False)
    cpu = E2E_CPU["logits"]
    err = ((lg - cpu).abs().max() / cpu.abs().max()).item() if lg.shape == cpu.shape else math.inf
    pairs = [(a, b) for g, h in zip(r0["generated"], host_out["generated"])
             for a, b in zip(g, h)]
    steps = max(r0["steps"], 1)
    rec = {"run": tag, "argv": r0["argv"], "ranks": M, "backend": r0["backend"],
           "param_shard_bytes": r0["param_shard_bytes"], "want_param_shard_bytes": TP_BYTES[M],
           "kv": {k: r0["kv"][k] for k in SERVE_KV},
           "host_kv": {k: host_out["kv"][k] for k in SERVE_KV},
           "tokens_equal_host_share": sum(a == b for a, b in pairs) / max(len(pairs), 1),
           "teacher_forced_max_rel_err": err, "tol": E2E_REL_TOL,
           "decode_step_ms": r0["decode_s"] / steps * 1e3,
           "host_decode_step_ms": host_out["timings"]["decode_s"]
           / max(host_out["steps"], 1) * 1e3,
           "prefill_wave_ms": r0["prefill_s"] / -(-len(r0["generated"]) // r0["slots"]) * 1e3,
           "ttft_p50_s": r0["ttft_p50_s"], "ttft_p99_s": r0["ttft_p99_s"],
           "peak_allocated_gb": [b / 1e9 for b in r0["peak_allocated_bytes"]],
           "launches_per_rank": [r["launches"] for r in recs]}
    say(f"{tag}:", json.dumps(rec))
    for r in recs:
        if not all(r["done"]) or r["generated"] != r0["generated"]:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']}: not every sequence finished, or "
                             "its tokens differ from rank 0's")
        if not r["param_shard_bytes"][r["rank"]] == TP_BYTES[M] == r["layout_param_bytes"]:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']} holds "
                             f"{r['param_shard_bytes'][r['rank']]} param bytes; "
                             f"want {TP_BYTES[M]}")
    if rec["kv"] != rec["host_kv"]:
        raise SystemExit(f"FAIL {tag}: kv bytes summed over the ranks {rec['kv']}, one "
                         f"rank's {rec['host_kv']}")
    if not err <= E2E_REL_TOL:
        raise SystemExit(f"FAIL {tag}: teacher-forced logits rel err {err} > {E2E_REL_TOL}")
    _check_tp_ranks(tag, recs)
    return rec, _sum_launches(recs)


def moe_model_axis_numerics_rank(strategy: str) -> dict:
    """(a rank) Phase 18's GSPMD step (granite at full width cut to 2
    layers, ``MOE_NUMERICS``, ZeRO-3) on a (1, M) mesh of the launch's M
    ranks under ``strategy`` ("tp": heads and experts split; "cp" forced:
    each rank its half of the sequence, the experts still split), each from
    its shards of the global state on the whole batch: the trajectory and
    each layer's routing plan as the routed groups see it (``route_tokens``
    on the whole sequences); rank 0 saves them with the params (outside
    and inside the expert rows) and f32 masters joined over the ranks."""
    M = int(os.environ["WORLD_SIZE"])
    mesh = mesh_mod.make_local_mesh(1, M, "cuda")
    rank, dev = mesh.rank, mesh.device
    layers, B, S, steps = MOE_NUMERICS
    cfg = dataclasses.replace(configs.get(MOE_ARCH), n_layers=layers)
    run = RunConfig(model=cfg, parallel=make_parallel("pjit", remat="none", zero_stage=3,
                                                      attn_strategy=strategy),
                    offload=make_offload(nvme_dir=os.path.join(ROOT, "build",
                                                               f"chip_smoke_moe_{strategy}")),
                    train=TrainConfig(lr=3e-3, steps=steps, seed=SEED))
    params0 = init_params(cfg)
    ops.reset_launch_counts()
    ex = InfinityExecutor(run, dev, mesh=mesh)
    eng = ex.engine
    full = {"params": params0, "opt": adam.init_state(params0)}
    state = ex.reseed(eng.place_state(bridge.shard_gspmd_state(full, run, rank, 1, M)))
    del full, params0
    stream = SyntheticStream(ex.input_specs(ShapeConfig("n", S, B, "train")),
                             cfg.vocab_size, seed=SEED)
    step = ex.make_train_step()
    traj, plans, real = [], [], moe_mod.route_tokens

    def route_tokens(router, xg, cfg_):
        r = real(router, xg, cfg_)
        plans.append(torch.where(r["valid_ec"], r["tok_ec"], -1).cpu())
        return r

    moe_mod.route_tokens = route_tokens
    try:
        for i in range(steps):
            batch = {k: torch.from_numpy(a).to(dev) for k, a in stream.batch_at(i).items()}
            state, m = step(state, batch)
            traj.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr",
                                                  "moe_dropped_token_fraction")})
    finally:
        moe_mod.route_tokens = real
    launches = ops.launch_counts()
    params = eng.respec(state["params"], "param", None)
    masters = eng.respec(state["opt"].master, "opt", None)
    if rank == 0:
        torch.save((traj, *_moe_param_groups(None, None, "gspmd", params=params),
                    {keystr(p): t.detach().float().cpu()
                     for p, t in zip(pt.tree_paths(masters), pt.tree_leaves(masters))}, plans),
                   _tp_record(f"moe_{strategy}_numerics"))
    ex.close()
    return {"rank": rank, "launches": launches, "transport": mesh.transport(),
            "strategy": eng.mp.strategy, "trajectory": traj,
            "param_shard_bytes": eng.shard_bytes()["param_shard_bytes"]}


def phase_moe_model_axis_numerics(recs: list, strategy: str) -> tuple:
    """The ranks' ``moe_model_axis_numerics_rank``: the trajectory one on
    every rank, the joined params and masters and the routing plans held
    against phase 18's kept CPU side ("moe numerics/gspmd") by its bounds
    (``hold_moe_to_cpu``); each rank's launches on the tensor cores."""
    tag = f"moe {strategy} numerics"
    card = torch.load(_tp_record(f"moe_{strategy}_numerics"), weights_only=False)
    for r in recs:
        if r["trajectory"] != card[0] or r["strategy"] != strategy:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']} ran {r['strategy']} and reports "
                             f"{r['trajectory']}, rank 0 {card[0]}")
    cfg = dataclasses.replace(configs.get(MOE_ARCH), n_layers=MOE_NUMERICS[0])
    rec = hold_moe_to_cpu(tag, cfg, MOE_CPU_RUNS["gspmd"], card, {
        "kind": "gspmd", "arch": MOE_ARCH, "mesh": [1, len(recs)], "strategy": strategy,
        "zero_stage": 3, "cpu_side": "one rank, kept (moe numerics/gspmd)",
        "param_shard_bytes": [r["param_shard_bytes"] for r in recs],
        "launches_per_rank": [r["launches"] for r in recs]})
    _check_tp_ranks(tag, recs, strategy, ("flash_attention", "flash_attention_bwd"))
    return rec, _sum_launches(recs)


def model_axis_bytes(arch: str, layers: int, M: int, strategy: str = "auto",
                     cut: dict | None = None) -> int:
    """``arch`` at full width cut to ``layers`` (0: whole; or by the config
    fields in ``cut``): a rank's param bytes on a (1, M) mesh under the
    attention ``strategy``, from the rules."""
    cfg = dataclasses.replace(configs.with_layers(configs.get(arch), layers), **(cut or {}))
    run = RunConfig(model=cfg, parallel=make_parallel("pjit", attn_strategy=strategy))
    return ZeroInfinityEngine(run, "cpu", mesh=mesh_mod.LocalMesh(
        1, M, 0, M, torch.device("cpu"), None, "gloo")).shard_bytes()["param_shard_bytes"]


def phase_moe_tp_train(recs: list, dp1: dict) -> tuple:
    """The ranks' "moe_tp_train" (``tp_train_rank`` on granite at
    ``MOE_LAYERED_LAYERS``, ``MOE_TRAIN_STEPS`` steps of 8 x 512, tensor
    parallelism over 2) held by ``phase_tp_train`` to "moe layered"'s
    losses (``dp1``) with the rules' param bytes a rank; the routing
    statistics equal on both ranks, the expert load summing to 1 and the
    last step's dropped fraction "moe layered"'s within a quarter of it:
    the global batch's, not the model ranks' sum."""
    tag = "moe tp train"
    want = model_axis_bytes(MOE_ARCH, MOE_LAYERED_LAYERS, len(recs))
    rec, launches = phase_tp_train(recs, dp1, tag, want, "tp", ("flash_attention",
                                                               "flash_attention_bwd"))
    for m0, *ms in zip(*(r["steps"] for r in recs)):
        for m in ms:
            if any(m[k] != m0[k] for k in MOE_STATS):
                raise SystemExit(f"FAIL {tag}: the ranks' routing statistics differ: {m0} {m}")
        if abs(sum(m0["moe_expert_load"]) - 1.0) > 1e-4:
            raise SystemExit(f"FAIL {tag}: the expert load sums to {sum(m0['moe_expert_load'])}")
    got, one = recs[0]["steps"][-1]["moe_dropped_token_fraction"], dp1["moe_dropped_token_fraction"]
    rec.update({"moe_dropped_token_fraction": got, "one_rank_dropped_fraction": one,
                "want_param_shard_bytes": want})
    say(f"{tag} routing:", json.dumps({k: rec[k] for k in (
        "moe_dropped_token_fraction", "one_rank_dropped_fraction", "want_param_shard_bytes")}))
    if not abs(got - one) <= 0.25 * one:
        raise SystemExit(f"FAIL {tag}: dropped fraction {got} vs one rank's {one}")
    return rec, launches


def check_model_serve(tag: str, recs: list, want_bytes: int, one_kv: dict,
                      one_generated, strategy: str) -> dict:
    """A serving run on a (1, M) mesh (``serve_rank``'s records): every
    sequence finished with the same tokens on every rank, each rank's
    param bytes ``want_bytes`` (its layout's), the ``kv`` bytes moved
    summed over the ranks ``one_kv`` (the one-rank run of the argv), the
    share of tokens equal to ``one_generated`` printed, every flash launch
    on the tensor cores; the decode step and prefill wave printed."""
    r0 = recs[0]
    steps = max(r0["steps"], 1)
    pairs = [(a, b) for g, h in zip(r0["generated"], one_generated) for a, b in zip(g, h)]
    rec = {"run": tag, "argv": r0["argv"], "ranks": len(recs), "strategy": strategy,
           "backend": r0["backend"], "param_shard_bytes": r0["param_shard_bytes"],
           "want_param_shard_bytes": want_bytes,
           "kv": {k: r0["kv"][k] for k in SERVE_KV},
           "kv_ranks": [{k: kr[k] for k in SERVE_KV} for kr in r0["kv_ranks"]],
           "one_rank_kv": one_kv, "cache_seq_split": r0["cache_seq_split"],
           "local_cache_len": r0["local_cache_len"],
           "model_gather_bytes_per_step": r0["model_gather_bytes_per_step"],
           "tokens_equal_one_rank_share": sum(a == b for a, b in pairs) / max(len(pairs), 1),
           "decode_step_ms": r0["decode_s"] / steps * 1e3,
           "prefill_wave_ms": r0["prefill_s"] / -(-len(r0["generated"]) // r0["slots"]) * 1e3,
           "ttft_p50_s": r0["ttft_p50_s"], "ttft_p99_s": r0["ttft_p99_s"],
           "peak_allocated_gb": [b / 1e9 for b in r0["peak_allocated_bytes"]],
           "launches_per_rank": [r["launches"] for r in recs]}
    say(f"{tag}:", json.dumps(rec))
    for r in recs:
        if not all(r["done"]) or r["generated"] != r0["generated"]:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']}: not every sequence finished, or "
                             "its tokens differ from rank 0's")
        if not r["param_shard_bytes"][r["rank"]] == want_bytes == r["layout_param_bytes"]:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']} holds "
                             f"{r['param_shard_bytes'][r['rank']]} param bytes; want {want_bytes}")
    moved = [k for k in SERVE_KV if k != "resident_bytes"]
    if any(rec["kv"][k] != one_kv[k] for k in moved):
        raise SystemExit(f"FAIL {tag}: kv bytes summed over the ranks {rec['kv']}, one "
                         f"rank's {one_kv}")
    _check_tp_ranks(tag, recs, strategy, ("flash_attention",))
    return rec


def phase_cp_serve(recs: list, one: dict) -> tuple:
    """The ranks' ``cp_serve_rank`` (full smollm-135m with
    ``TP_SERVE_ARGV`` on (1, 2): context parallelism) against ``one``, the
    one-rank run of the argv ("tp serve one rank"), by
    ``check_model_serve`` with ``TP_BYTES[2]`` a rank; its 520 positions
    split 260 a rank, each rank's resident K/V half of ``one``'s (model
    rank 0 holds the slots' ``len`` leaf), the tiled matmul launched on the
    tensor cores, phase 4's teacher-forced logits at 2 layers held to its
    CPU side by ``E2E_REL_TOL``."""
    tag, M = "cp serve", len(recs)
    rec = check_model_serve(tag, recs, TP_BYTES[M], {k: one["kv"][k] for k in SERVE_KV},
                            one["generated"], "cp")
    lg = torch.load(_tp_record("cp_serve_logits"), weights_only=False)
    cpu = E2E_CPU["logits"]
    err = ((lg - cpu).abs().max() / cpu.abs().max()).item() if lg.shape == cpu.shape else math.inf
    lens = 4 * len(recs[0]["generated"][:one["slots"]])  # the slots' int32 len leaf
    kv_one = one["kv"]["resident_bytes"] - lens
    resident = [kr["resident_bytes"] - (lens if r == 0 else 0)
                for r, kr in enumerate(rec["kv_ranks"])]
    rec.update({"teacher_forced_max_rel_err": err, "tol": E2E_REL_TOL,
                "resident_kv_ranks": resident, "one_rank_resident_kv": kv_one,
                "one_rank_decode_step_ms": one["timings"]["decode_s"]
                / max(one["steps"], 1) * 1e3})
    say(f"{tag} checks:", json.dumps({k: rec[k] for k in (
        "teacher_forced_max_rel_err", "resident_kv_ranks", "one_rank_resident_kv",
        "one_rank_decode_step_ms")}))
    if not rec["cache_seq_split"] or any(M * b != kv_one for b in resident):
        raise SystemExit(f"FAIL {tag}: resident K/V a rank {resident}, one rank's {kv_one}")
    if not err <= E2E_REL_TOL:
        raise SystemExit(f"FAIL {tag}: teacher-forced logits rel err {err} > {E2E_REL_TOL}")
    _check_tp_ranks(tag, recs, "cp")
    return rec, _sum_launches(recs)


def phase_recurrent_serve(tag: str, recs: list, one_tag: str, strategy: str,
                          kernels=(), none=()) -> tuple:
    """A recurrent family served on a (1, M) mesh (``serve_rank``'s records
    of ``SSM_SERVE_ARGV`` / ``HYBRID_SERVE_ARGV`` with ``--model-mesh M``)
    against the one-rank run ``one_tag`` ("ssm serve": the same model and
    prompts at more new tokens; "hybrid tp serve one rank": the same argv):
    every sequence finished
    with the same tokens on every rank, each rank's param bytes its
    layout's (the rules'), each rank's parked ``kv`` bytes in and out its
    admissions' caches in its layout (its ``inner`` channels, the leaves
    every model rank holds whole, the ``len`` leaf on model rank 0), the
    share of tokens equal to the one rank's first ones printed beside the
    param bytes a rank and the ``kv`` summed and per rank; the launches
    by ``_check_tp_ranks``."""
    one = FAMILY_SERVE_ONE[one_tag]
    r0, M = recs[0], len(recs)
    n_new = len(r0["generated"][0])
    pairs = [(a, b) for g, h in zip(r0["generated"], one["generated"])
             for a, b in zip(g, h[:n_new])]
    steps = max(r0["steps"], 1)
    want_kv = [r0["admissions_ranks"][r] * (recs[r]["cache_bytes_per_seq"] - (4 if r else 0))
               for r in range(M)]
    rec = {"run": tag, "argv": r0["argv"], "ranks": M, "strategy": strategy,
           "backend": r0["backend"], "param_shard_bytes": r0["param_shard_bytes"],
           "layout_param_bytes": [r["layout_param_bytes"] for r in recs],
           "one_rank_param_bytes": r0["one_rank_param_bytes"],
           "kv": {k: r0["kv"][k] for k in SERVE_KV},
           "kv_ranks": [{k: kr[k] for k in SERVE_KV} for kr in r0["kv_ranks"]],
           "want_kv_out_ranks": want_kv,
           "cache_bytes_per_seq_ranks": [r["cache_bytes_per_seq"] for r in recs],
           "one_rank_kv": {k: one["kv"][k] for k in SERVE_KV},
           "tokens_equal_one_rank_share": sum(a == b for a, b in pairs) / max(len(pairs), 1),
           "decode_step_ms": r0["decode_s"] / steps * 1e3,
           "one_rank_decode_step_ms": one["timings"]["decode_s"] / max(one["steps"], 1) * 1e3,
           "prefill_wave_ms": r0["prefill_s"] / -(-len(r0["generated"]) // r0["slots"]) * 1e3,
           "ttft_p50_s": r0["ttft_p50_s"], "ttft_p99_s": r0["ttft_p99_s"],
           "peak_allocated_gb": [b / 1e9 for b in r0["peak_allocated_bytes"]],
           "launches_per_rank": [r["launches"] for r in recs]}
    say(f"{tag}:", json.dumps(rec))
    for r in recs:
        if not all(r["done"]) or r["generated"] != r0["generated"]:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']}: not every sequence finished, or "
                             "its tokens differ from rank 0's")
        if r["param_shard_bytes"][r["rank"]] != r["layout_param_bytes"]:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']} holds "
                             f"{r['param_shard_bytes'][r['rank']]} param bytes; want "
                             f"{r['layout_param_bytes']}")
    for r, kr in enumerate(r0["kv_ranks"]):
        if not kr["out_bytes"] == kr["in_bytes"] == want_kv[r] > 0:
            raise SystemExit(f"FAIL {tag}: rank {r} parked {kr['out_bytes']} and fetched "
                             f"{kr['in_bytes']} bytes; want {want_kv[r]}")
    _check_tp_ranks(tag, recs, strategy, kernels, none)
    return rec, _sum_launches(recs)


def phase_encdec_tp_serve(recs: list, one: dict) -> tuple:
    """The ranks' "encdec_tp_serve" (full seamless with
    ``ENCDEC_TP_SERVE_ARGV`` on (1, 2): tensor parallelism) by
    ``check_model_serve`` against ``one``, the one-rank run of the argv
    ("encdec tp serve one rank"), the rules' bytes a rank; each rank parks
    and fetches its own cache of each sequence it admits: its KV heads of
    the decoder's K/V up to the 512 prompt tokens and of the memory's
    ``xk`` / ``xv`` at the 2048 frames, half the one rank's (the ``len``
    placeholder on model rank 0), their ``xk`` / ``xv`` bytes printed;
    every flash and tiled-matmul launch on the tensor cores."""
    tag, M = "encdec tp serve", len(recs)
    cfg = configs.get(ENCDEC_ARCH)
    rec = check_model_serve(tag, recs, model_axis_bytes(ENCDEC_ARCH, 0, M),
                            {k: one["kv"][k] for k in SERVE_KV}, one["generated"], "tp")
    frames = int(ENCDEC_TP_SERVE_ARGV[ENCDEC_TP_SERVE_ARGV.index("--prompt-len") + 1])
    new = int(ENCDEC_TP_SERVE_ARGV[-1])
    per_rank = (parked_seq_bytes(cfg, frames, new) - 4) // M  # the len placeholder apart
    admitted = recs[0]["admissions_ranks"]
    want = [admitted[r] * (per_rank + (4 if r == 0 else 0)) for r in range(M)]
    rec.update({"one_rank_decode_step_ms": one["timings"]["decode_s"]
                / max(one["steps"], 1) * 1e3, "want_kv_out_ranks": want,
                "xk_xv_bytes_per_seq_rank": 2 * cfg.n_dec_layers * frames
                * (cfg.n_kv_heads // M) * cfg.resolved_head_dim * 2})
    say(f"{tag} checks:", json.dumps({k: rec[k] for k in (
        "one_rank_decode_step_ms", "want_kv_out_ranks", "xk_xv_bytes_per_seq_rank")}))
    for r, kr in enumerate(rec["kv_ranks"]):
        if not kr["out_bytes"] == kr["in_bytes"] == want[r] > 0:
            raise SystemExit(f"FAIL {tag}: rank {r} parked {kr['out_bytes']} and fetched "
                             f"{kr['in_bytes']} bytes; want {want[r]}")
    _check_tp_ranks(tag, recs, "tp", ("flash_attention", "tiled_matmul"))
    return rec, _sum_launches(recs)


def phase_encdec_cp_serve(recs: list, one: dict) -> tuple:
    """The ranks' "encdec_cp_serve" (seamless cut to
    ``ENCDEC_CP_SERVE_CUT`` with ``ENCDEC_CP_SERVE_ARGV`` on (1, 2),
    context parallelism forced) by ``check_model_serve`` against ``one``,
    the one-rank run of the same cut and argv, the rules' context-parallel
    bytes a rank; the decode cache split: each rank's resident cache its
    two slots' 258 of the 516 decoder positions and 1024 of the 2048
    memory positions (``xk`` / ``xv``), half the one rank's (the slots'
    ``len`` leaf on model rank 0); flash and the tiled matmul on the tensor
    cores."""
    tag, M = "encdec cp serve", len(recs)
    frames = int(ENCDEC_CP_SERVE_ARGV[ENCDEC_CP_SERVE_ARGV.index("--prompt-len") + 1])
    cap = frames // 4 + int(ENCDEC_CP_SERVE_ARGV[-1])
    cfg = encdec_cp_serve_cfg()
    want_bytes = model_axis_bytes(ENCDEC_ARCH, 0, M, "cp", ENCDEC_CP_SERVE_CUT)
    rec = check_model_serve(tag, recs, want_bytes, {k: one["kv"][k] for k in SERVE_KV},
                            one["generated"], "cp")
    row = cfg.n_dec_layers * cfg.n_kv_heads * cfg.resolved_head_dim * 2  # bf16, a position
    slots = one["slots"]
    lens = 4 * slots  # the slots' int32 len leaf
    want = slots * 2 * row * (cap + frames) // M
    resident = [kr["resident_bytes"] - (lens if r == 0 else 0)
                for r, kr in enumerate(rec["kv_ranks"])]
    one_resident = one["kv"]["resident_bytes"] - lens
    rec.update({"resident_kv_ranks": resident, "want_resident_kv_rank": want,
                "one_rank_resident_kv": one_resident, "cut": ENCDEC_CP_SERVE_CUT,
                "xk_xv_bytes_per_seq_rank": 2 * row * frames // M,
                "one_rank_decode_step_ms": one["timings"]["decode_s"]
                / max(one["steps"], 1) * 1e3})
    say(f"{tag} checks:", json.dumps({k: rec[k] for k in (
        "resident_kv_ranks", "want_resident_kv_rank", "one_rank_resident_kv",
        "xk_xv_bytes_per_seq_rank", "one_rank_decode_step_ms")}))
    if not (rec["cache_seq_split"] and rec["local_cache_len"] == cap // M
            and all(b == want and M * b == one_resident for b in resident)):
        raise SystemExit(f"FAIL {tag}: resident K/V a rank {resident} over "
                         f"{rec['local_cache_len']} positions; want {want} of one rank's "
                         f"{one_resident}")
    _check_tp_ranks(tag, recs, "cp", ("flash_attention", "tiled_matmul"))
    return rec, _sum_launches(recs)


def phase_moe_tp_serve(recs: list) -> tuple:
    """The ranks' "moe_tp_serve" (full granite with phase 18's argv on (1,
    2): tensor parallelism, 16 experts a rank) by ``check_model_serve``
    against "moe serve" (``MOE_SERVE_ONE``), ``MOE_TP_BYTES[2]`` a rank."""
    one = MOE_SERVE_ONE["out"]
    rec = check_model_serve("moe tp serve", recs, MOE_TP_BYTES[len(recs)],
                            {k: one["kv"][k] for k in SERVE_KV}, one["generated"], "tp")
    rec["one_rank_decode_step_ms"] = one["timings"]["decode_s"] / max(one["steps"], 1) * 1e3
    say("moe tp serve one rank decode step ms:", json.dumps(rec["one_rank_decode_step_ms"]))
    return rec, _sum_launches(recs)


def phase_resume_drill() -> tuple:
    """Full smollm-135m, the explicit in-graph step: 6 steps uninterrupted,
    then the same run with a checkpoint every 2 steps and a failure
    injected at step 3 (``REPRO_FAIL_AT_STEP``), resumed with ``--resume
    auto``: one restart, and the redone steps' losses equal the
    uninterrupted run's bit for bit (the checkpoint restores every leaf of
    the state bit for bit, and the kernels sum in a fixed order: no
    atomics). Then the layered NVMe epoch resumes from the drill's last
    checkpoint (a tier migration: its moments restart at zero) and trains
    one step. Counters zeroed just before the drill and read just after."""
    steps, fail_at = 6, 3
    root = os.path.join(ROOT, "build", "chip_smoke_resume")
    shutil.rmtree(root, ignore_errors=True)
    base = ["--arch", "smollm-135m", "--engine", "zero3", "--batch", "8", "--seq", "512",
            "--lr", "3e-3", "--log-every", "1"]

    def run(argv, env=None):
        old = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            return train.train(train.build_argparser().parse_args(argv), argv)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    ref = run(base + ["--steps", str(steps), "--ckpt-every", "0",
                      "--ckpt-dir", os.path.join(root, "ref")])
    ckpt_dir = os.path.join(root, "ckpt")
    drill_argv = base + ["--steps", str(steps), "--ckpt-every", "2", "--ckpt-dir", ckpt_dir,
                         "--resume", "auto"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    drill = run(drill_argv, {"REPRO_FAIL_AT_STEP": str(fail_at),
                             "REPRO_FAIL_MARKER": os.path.join(root, "marker")})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    # the drill's losses: steps 0-2, then from the checkpoint at step 2 again
    resumed = [m["loss"] for m in drill["metrics"][fail_at:]]
    want = ref["losses"][2:]
    diffs = [abs(a - b) for a, b in zip(resumed, want)]
    mig_argv = base + ["--steps", str(steps + 1), "--ckpt-every", "0", "--ckpt-dir", ckpt_dir,
                       "--resume", "auto", "--offload-param", "nvme", "--offload-grad",
                       "nvme", "--offload-opt", "nvme", "--nvme-dir",
                       os.path.join(root, "nvme")]
    mig = run(mig_argv)
    rec = {"argv": " ".join(drill_argv), "fail_at_step": fail_at, "wall_s": wall,
           "restarts": drill["restarts"], "recovery_s": drill["recovery_s"],
           "uninterrupted_losses": ref["losses"], "drill_losses": drill["losses"],
           "resumed_max_abs_diff": max(diffs) if diffs else None,
           "checkpoint": drill["checkpoint"],
           "migration": {"argv": " ".join(mig_argv), "steps": [m["step"] for m in mig["metrics"]],
                         "losses": mig["losses"], "restore_s": mig["checkpoint"]["restore_s"]},
           "launches": launches}
    say("resume drill:", json.dumps(rec))
    ck = drill["checkpoint"]
    say(f"checkpoint: {ck['bytes']} bytes, snapshot {ck['snapshot_s'] * 1e3:.1f} ms, "
        f"persist {ck['persist_s']:.3f} s, restore {ck['restore_s']:.3f} s "
        f"({ck['saves']} saves)")
    if drill["restarts"] != 1:
        raise SystemExit(f"FAIL resume drill: {drill['restarts']} restarts, want 1")
    if len(resumed) != steps - 2 or resumed != want:
        raise SystemExit(f"FAIL resume drill: resumed losses {resumed} != uninterrupted {want}")
    if [m["step"] for m in mig["metrics"]] != [steps] or not math.isfinite(mig["losses"][0]):
        raise SystemExit(f"FAIL resume drill: the layered epoch did not train step {steps} "
                         f"from the checkpoint: {rec['migration']}")
    return rec, launches


# the ranks' slow-tier state (two ranks in the dp-2 spawn): params on NVMe
# through the GSPMD leaf scheduler, and checkpoints on ranks
NVME_TRAIN_STEPS = 2
# where the ranks' checkpoints wait for the main process's restores (not
# ``chip_smoke_*``: ``timed`` removes those after the spawn's phase)
CKPT_DRILL_DIR = os.path.join(ROOT, "build", "ckpt_dp2_drill")
CKPT_ZERO3_DIR = os.path.join(ROOT, "build", "ckpt_zero3_dp2")
DRILL_FAIL_AT = 3


def _with_env(env: dict, fn):
    """``fn()`` with ``env`` set in the process's environment around it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rank_layout(run, mesh) -> ZeroInfinityEngine:
    """The GSPMD engine's layout on this rank (a CPU engine on the rank's
    mesh: no collective)."""
    return ZeroInfinityEngine(run, "cpu", mesh=dataclasses.replace(mesh, device="cpu"))


def _spec_bytes(specs) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in pt.tree_leaves(specs))


def q8_rounding_norm_sq(run, mesh, seed: int = SEED) -> float:
    """The squared L2 norm of q8's rounding of this rank's param shards as
    the run draws them (``engine.init_params`` from the run's seeded
    generator on the card): each shard encoded on its own grid and
    decoded, less the shard."""
    eng = ZeroInfinityEngine(run, mesh.device, mesh=mesh)
    params = eng.init_params(torch.Generator(device=mesh.device).manual_seed(seed))
    total = 0.0
    for t in pt.tree_leaves(params):
        x = t.detach().cpu()
        d = qformat.decode_array(qformat.encode_array(x, "q8")).float() - x.float()
        total += float(torch.sum(d.double() ** 2))
    return total


def nvme_train_rank(model: int = 1, quant: str = "none") -> dict:
    """(a rank) ``launch.train --engine pjit`` on full smollm-135m with its
    params on NVMe through the leaf scheduler, ``NVME_TRAIN_STEPS`` steps of
    8 x 512: on ``model`` = 1 a data mesh of the launch's ranks with every
    state class on NVMe (the host Adam over the rank's optimizer shards;
    ``quant`` encodes each shard in the param store), on ``model`` > 1 a
    (1, M) mesh, context parallelism, the in-graph update. This rank's
    step metrics, the bytes of its param shards (and their q8 frames), the
    leaves it holds whole, launches and peak memory; its stores removed
    after."""
    n = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    tag = f"m{model}_{quant}"
    nvme = os.path.join(ROOT, "build", f"chip_smoke_gspmd_nvme_{tag}")
    mesh_flags = (["--data-mesh", str(n)] if model == 1 else
                  ["--data-mesh", "1", "--model-mesh", str(model)])
    tiers = (["--offload-param", "nvme", "--offload-grad", "nvme", "--offload-opt", "nvme"]
             if model == 1 else ["--offload-param", "nvme"])
    argv = ["--arch", "smollm-135m", "--engine", "pjit", "--zero-stage", "3", *mesh_flags,
            *tiers, "--param-quant", quant, "--batch", "8", "--seq", "512",
            "--steps", str(NVME_TRAIN_STEPS), "--lr", "3e-3", "--nvme-dir", nvme,
            "--ckpt-every", "0", "--log-every", "1"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.train(train.build_argparser().parse_args(argv), argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    mesh, run = hist["mesh"], hist["run"]
    layout = _rank_layout(run, mesh)
    specs = layout.param_specs()
    rec = {"rank": mesh.rank, "argv": " ".join(argv), "wall_s": wall,
           "launches": launches, "transport": mesh.transport(),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "shard_bytes": _spec_bytes(specs),
           "one_rank_bytes": _spec_bytes(layout.param_specs(whole=True)),
           "unsplit_leaves": layout.unsplit_leaves("param"),
           "steps": [{k: m[k] for k in (
               "step", "loss", "grad_norm", "param_in_bytes", "param_out_bytes",
               "param_in_wire_bytes", "param_out_wire_bytes", "param_in_gbps",
               "param_out_gbps", "param_total_bytes", "param_total_bytes_all_ranks",
               "peak_resident_param_bytes", "opt_read_bytes", "opt_write_bytes",
               "grad_out_bytes") if k in m} | {"step_s": m["step_time"]}
                     for m in hist["metrics"]]}
    if model > 1:
        rec["strategy"] = pt.choose_attn_strategy(run.model, mesh.axis_sizes(), run.parallel)
    if quant != "none":
        rec["wire_bytes"] = sum(qformat.wire_nbytes(sp.shape, sp.dtype, quant)
                                for sp in pt.tree_leaves(specs))
        rec["q8_rounding_norm_sq"] = q8_rounding_norm_sq(run, mesh)
    shutil.rmtree(os.path.join(nvme, f"rank{rank}"), ignore_errors=True)
    return rec


def ckpt_drill_rank() -> dict:
    """(a rank) "gspmd dp2 train"'s argv (``--plan auto --hw-devices N``,
    the in-graph GSPMD step, ``DP_TRAIN_STEPS`` steps of 8 x 512) with a
    checkpoint every 2 steps into ``CKPT_DRILL_DIR``, a failure injected at
    step ``DRILL_FAIL_AT`` on every rank (each its own marker) and
    ``--resume auto``: this rank's losses (the redone steps among them),
    restarts, its checkpoint timings and bytes (rank 0 writes), and the
    bytes one rank's checkpoint of the same state holds (the params in
    their dtypes, f32 master, m and v, the int32 step count)."""
    n = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    marker = os.path.join(ROOT, "build", "chip_smoke_ckpt_marker")
    argv = ["--arch", "smollm-135m", "--plan", "auto", "--hw-devices", str(n),
            "--batch", "8", "--seq", "512", "--steps", str(DP_TRAIN_STEPS), "--lr", "3e-3",
            "--nvme-dir", os.path.join(ROOT, "build", "chip_smoke_ckpt_nvme"),
            "--ckpt-every", "2", "--ckpt-dir", CKPT_DRILL_DIR, "--resume", "auto",
            "--log-every", "1"]
    if rank == 0:
        shutil.rmtree(CKPT_DRILL_DIR, ignore_errors=True)
    if os.path.exists(f"{marker}.rank{rank}"):
        os.remove(f"{marker}.rank{rank}")
    torch.distributed.barrier()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = _with_env({"REPRO_FAIL_AT_STEP": str(DRILL_FAIL_AT), "REPRO_FAIL_MARKER": marker},
                     lambda: train.train(train.build_argparser().parse_args(argv), argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    whole = ZeroInfinityEngine(hist["run"], "cpu").param_specs(whole=True)
    n_params = sum(math.prod(sp.shape) for sp in pt.tree_leaves(whole))
    return {"rank": hist["mesh"].rank, "argv": " ".join(argv), "wall_s": wall,
            "launches": ops.launch_counts(), "restarts": hist["restarts"],
            "recovery_s": hist["recovery_s"], "losses": hist["losses"],
            "steps": [m["step"] for m in hist["metrics"]],
            "checkpoint": hist["checkpoint"],
            "one_rank_checkpoint_bytes": _spec_bytes(whole) + 12 * n_params + 4,
            "marker": os.path.exists(f"{marker}.rank{rank}")}


def check_nvme_train(tag: str, recs: list, dp1_losses: list, want_bytes: int = 0,
                     strategy: str = "") -> dict:
    """The checks of ``nvme_train_rank``'s records: each step each rank
    reads and writes its param shards' bytes once (``param_in`` =
    ``param_out`` = ``param_total_bytes`` = its shards', an n-th of one
    rank's where every leaf splits, ``want_bytes`` where given); the
    leaves never all resident (peak below the total); the losses equal on
    every rank, finite and those of ``dp1_losses`` by ``TRAIN_TOL`` (None:
    not held here); every rank's launches on the tensor cores."""
    n, r0 = len(recs), recs[0]
    for r in recs:
        for m in r["steps"]:
            say(f"{tag} step:", json.dumps({"rank": r["rank"], **m}))
    losses = [m["loss"] for m in r0["steps"]]
    rec = {"argv": r0["argv"], "transport": r0["transport"], "losses": losses,
           "dp1_losses": dp1_losses[:len(losses)] if dp1_losses else None,
           "shard_bytes": [r["shard_bytes"] for r in recs], "one_rank_bytes": r0["one_rank_bytes"],
           "unsplit_leaves": r0["unsplit_leaves"], "wall_s": [r["wall_s"] for r in recs],
           "peak_allocated_gb": [r["peak_allocated_gb"] for r in recs],
           "step_s": [m["step_s"] for m in r0["steps"]],
           "param_in_gbps": [m["param_in_gbps"] for m in r0["steps"]],
           "param_out_gbps": [m["param_out_gbps"] for m in r0["steps"]],
           "peak_resident_param_bytes": [m["peak_resident_param_bytes"] for m in r0["steps"]],
           "launches_per_rank": [r["launches"] for r in recs]}
    say(f"{tag}:", json.dumps(rec))
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"FAIL {tag}: losses not finite: {losses}")
    for r in recs:
        if [m["loss"] for m in r["steps"]] != losses:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']}'s losses differ from rank 0's")
        want = want_bytes or r["shard_bytes"]
        for m in r["steps"]:
            moved = (m["param_in_bytes"], m["param_out_bytes"], m["param_total_bytes"])
            if moved != (want,) * 3 or r["shard_bytes"] != want:
                raise SystemExit(f"FAIL {tag}: rank {r['rank']} step {m['step']} param "
                                 f"in/out/total {moved}; its shards hold {r['shard_bytes']}, "
                                 f"want {want}")
            if not 0 < m["peak_resident_param_bytes"] < m["param_total_bytes"]:
                raise SystemExit(f"FAIL {tag}: rank {r['rank']} peak resident param bytes "
                                 f"{m['peak_resident_param_bytes']} of "
                                 f"{m['param_total_bytes']}")
    if not want_bytes and not r0["unsplit_leaves"]:
        if n * r0["shard_bytes"] != r0["one_rank_bytes"]:
            raise SystemExit(f"FAIL {tag}: {n} x {r0['shard_bytes']} param bytes a rank != one "
                             f"rank's {r0['one_rank_bytes']}, and no leaf stays whole")
    if dp1_losses:
        for got, want in zip(losses, rec["dp1_losses"]):
            if not abs(got - want) <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(want):
                raise SystemExit(f"FAIL {tag}: loss {got} vs the one-rank run's {want}")
    _check_tp_ranks(tag, recs, strategy or "dp", ("flash_attention", "tiled_matmul"))
    return rec


def phase_gspmd_nvme_train(recs: list, dp1: dict) -> tuple:
    """The ranks' "gspmd_nvme_train": every state class on NVMe at (2, 1),
    full smollm, held against "plan train"'s losses (the same seed and
    global batches, all on the device) by ``TRAIN_TOL``; the wire bytes
    the logical ones."""
    tag = "gspmd nvme dp2 train"
    rec = check_nvme_train(tag, recs, dp1["losses"])
    for r in recs:
        for m in r["steps"]:
            if (m["param_in_wire_bytes"], m["param_out_wire_bytes"]) != (r["shard_bytes"],) * 2:
                raise SystemExit(f"FAIL {tag}: rank {r['rank']} wire bytes differ from bf16's")
    return rec, _sum_launches(recs)


def q8_loss_bound(step: int, bf16_loss: float, bf16_grad_norm: float, norm_sq: float) -> float:
    """How far q8's rounding of the params may move a step's loss from the
    bf16 run's: ``TRAIN_TOL`` plus, to first order, the gradient's norm
    times the rounding's (Cauchy-Schwarz), ``step + 1`` roundings deep
    (each write-back rounds again)."""
    return (TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(bf16_loss)
            + (step + 1) * bf16_grad_norm * math.sqrt(norm_sq))


def phase_gspmd_nvme_q8_train(recs: list, bf16: list) -> tuple:
    """The ranks' "gspmd_nvme_q8_train": the same run with ``--param-quant
    q8``, each rank's shards on their own grids: each step's wire bytes the
    shards' q8 frames (``qformat.wire_nbytes``: 34 bytes a 32-element
    block, a ragged shard's pad block included, and each frame's header),
    the logical bytes the bf16 run's; the losses within ``q8_loss_bound``
    of the bf16 run's ("gspmd_nvme_train", ``bf16``), the rounding's norm
    summed over the ranks."""
    tag = "gspmd nvme q8 dp2 train"
    rec = check_nvme_train(tag, recs, None)
    norm_sq = sum(r["q8_rounding_norm_sq"] for r in recs)
    b0 = bf16[0]
    gaps, bounds = [], []
    for i, m in enumerate(recs[0]["steps"]):
        want = b0["steps"][i]
        gaps.append(abs(m["loss"] - want["loss"]))
        bounds.append(q8_loss_bound(i, want["loss"], want["grad_norm"], norm_sq))
    rec.update(q8_rounding_norm=math.sqrt(norm_sq), bf16_losses=[m["loss"] for m in b0["steps"]],
               loss_gap=gaps, loss_bound=bounds,
               wire_bytes=[r["wire_bytes"] for r in recs],
               compression=recs[0]["shard_bytes"] / recs[0]["wire_bytes"])
    say(f"{tag} q8:", json.dumps({k: rec[k] for k in ("q8_rounding_norm", "bf16_losses",
                                                       "loss_gap", "loss_bound", "wire_bytes",
                                                       "compression")}))
    for r, b in zip(recs, bf16):
        if r["shard_bytes"] != b["shard_bytes"]:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']} logical bytes {r['shard_bytes']} "
                             f"!= the bf16 run's {b['shard_bytes']}")
        for m in r["steps"]:
            if (m["param_in_wire_bytes"], m["param_out_wire_bytes"]) != (r["wire_bytes"],) * 2:
                raise SystemExit(f"FAIL {tag}: rank {r['rank']} step {m['step']} wire bytes "
                                 f"{m['param_in_wire_bytes']} / {m['param_out_wire_bytes']}; "
                                 f"the shards' q8 frames hold {r['wire_bytes']}")
    for i, (gap, bound) in enumerate(zip(gaps, bounds)):
        if not gap <= bound:
            raise SystemExit(f"FAIL {tag}: step {i} loss {gap} from the bf16 run's; "
                             f"q8's rounding bounds it by {bound}")
    return rec, _sum_launches(recs)


def phase_cp_nvme_train(recs: list, dp1: dict) -> tuple:
    """The ranks' "cp_nvme_train": full smollm on (1, 2) (context
    parallelism) with its params on NVMe and the in-graph update: each
    step each rank reads and writes ``TP_BYTES[2]`` param bytes; "plan
    train"'s losses by ``TRAIN_TOL``."""
    rec = check_nvme_train("cp nvme train", recs, dp1["losses"], TP_BYTES[2], "cp")
    return rec, _sum_launches(recs)


def phase_ckpt_drill(recs: list, gtrain: list) -> tuple:
    """The ranks' "ckpt_drill": one restart on every rank (each rank's
    marker written), its losses those of "gspmd dp2 train" (``gtrain``:
    the same argv without the drill) bit for bit, the redone steps among
    them; rank 0's checkpoint the bytes a one-rank checkpoint of the same
    state holds, rank 1 writing none; the snapshot, persist and restore
    times printed."""
    tag = "ckpt dp2 drill"
    r0 = recs[0]
    want = [m["loss"] for m in gtrain[0]["steps"]]
    ck = r0["checkpoint"]
    rec = {"argv": r0["argv"], "fail_at_step": DRILL_FAIL_AT,
           "restarts": [r["restarts"] for r in recs], "recovery_s": r0["recovery_s"],
           "steps": r0["steps"], "losses": r0["losses"], "gspmd_dp2_train_losses": want,
           "checkpoint": ck, "one_rank_checkpoint_bytes": r0["one_rank_checkpoint_bytes"],
           "wall_s": [r["wall_s"] for r in recs], "launches_per_rank": [r["launches"] for r in recs]}
    say(f"{tag}:", json.dumps(rec))
    say(f"{tag} checkpoint: {ck['bytes']} bytes, snapshot {ck['snapshot_s'] * 1e3:.1f} ms, "
        f"persist {ck['persist_s']:.3f} s, restore {ck['restore_s']:.3f} s ({ck['saves']} saves)")
    redo = [s for s in range(DRILL_FAIL_AT)] + list(range(2, DP_TRAIN_STEPS))
    for r in recs:
        if r["restarts"] != 1 or not r["marker"]:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']} restarted {r['restarts']} times "
                             f"(marker written: {r['marker']}); want 1")
        if r["steps"] != redo or r["losses"] != [want[s] for s in redo]:
            raise SystemExit(f"FAIL {tag}: rank {r['rank']} steps {r['steps']} losses "
                             f"{r['losses']}; want steps {redo} with gspmd dp2 train's {want}")
    if ck["bytes"] != r0["one_rank_checkpoint_bytes"] or recs[1]["checkpoint"]["saves"]:
        raise SystemExit(f"FAIL {tag}: rank 0 wrote {ck['bytes']} bytes (one rank's checkpoint "
                         f"of the state: {r0['one_rank_checkpoint_bytes']}); rank 1 saved "
                         f"{recs[1]['checkpoint']['saves']} times")
    check_main_path_routes(tag, _sum_launches(recs))
    return rec, _sum_launches(recs)


def _resume_one_rank(tag: str, argv: list, ckpt_dir: str) -> tuple:
    """``launch.train`` on one rank resuming the newest checkpoint in
    ``ckpt_dir`` (written on two ranks) for one step; counters zeroed just
    before and read just after; the directory removed after."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.train(train.build_argparser().parse_args(argv), argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rec = {"argv": " ".join(argv), "wall_s": wall, "steps": [m["step"] for m in hist["metrics"]],
           "losses": hist["losses"], "restore_s": hist["checkpoint"]["restore_s"]}
    say(f"{tag}:", json.dumps(rec))
    check_main_path_routes(tag, launches)
    return rec, launches


def phase_ckpt_reshard(drill: list) -> tuple:
    """The drill's step-2 checkpoint (two ranks) restored on one rank, its
    newest dropped: one step (step 2) within ``TRAIN_TOL`` of the ranks'
    step 2."""
    tag = "ckpt reshard"
    shutil.rmtree(os.path.join(CKPT_DRILL_DIR, f"step-{DP_TRAIN_STEPS:08d}"), ignore_errors=True)
    argv = ["--arch", "smollm-135m", "--plan", "auto", "--batch", "8", "--seq", "512",
            "--steps", "3", "--lr", "3e-3", "--ckpt-every", "0", "--ckpt-dir", CKPT_DRILL_DIR,
            "--resume", "auto", "--log-every", "1",
            "--nvme-dir", os.path.join(ROOT, "build", "chip_smoke_reshard_nvme")]
    rec, launches = _resume_one_rank(tag, argv, CKPT_DRILL_DIR)
    want = drill[0]["losses"][2]
    if rec["steps"] != [2] or not abs(rec["losses"][0] - want) <= (
            TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(want)):
        raise SystemExit(f"FAIL {tag}: steps {rec['steps']} losses {rec['losses']}; want step 2 "
                         f"by TRAIN_TOL of the ranks' {want}")
    return rec, launches


def phase_zero3_ckpt_restore(train_ranks: list) -> tuple:
    """The layered zero3 dp-2 run's last checkpoint (its rows padded for 2
    ranks, written by rank 0) restored on one rank, the rows re-padded for
    it (``runtime/elastic.adapt_state_layout``; full smollm's 3,540,096
    elements a row split over 2 ranks as they are, so the re-pad is the
    identity here: tests/test_torch_checkpoint_mesh.py re-pads d_model
    47's), the layered epoch with every state on NVMe: one step, finite."""
    tag = "ckpt zero3 reshard"
    argv = ["--arch", "smollm-135m", "--engine", "zero3", "--offload-param", "nvme",
            "--offload-grad", "nvme", "--offload-opt", "nvme", "--batch", "8", "--seq", "512",
            "--steps", str(DP_TRAIN_STEPS + 1), "--lr", "3e-3", "--ckpt-every", "0",
            "--ckpt-dir", CKPT_ZERO3_DIR, "--resume", "auto", "--log-every", "1",
            "--nvme-dir", os.path.join(ROOT, "build", "chip_smoke_zero3_reshard_nvme")]
    rows = {n: ExplicitZero3Engine(RunConfig(model=configs.get("smollm-135m"),
                                             parallel=make_parallel("zero3")),
                                   "cpu", None if n == 1 else types_mesh(n)).layout.padded
            for n in (1, 2)}
    say(f"{tag} rows: padded {rows[2]} at dp 2, {rows[1]} at dp 1")
    rec, launches = _resume_one_rank(tag, argv, CKPT_ZERO3_DIR)
    rec.update(padded_dp2=rows[2], padded_dp1=rows[1],
               dp2_losses=[m["loss"] for m in train_ranks[0]["steps"]])
    if rec["steps"] != [DP_TRAIN_STEPS] or not all(math.isfinite(x) for x in rec["losses"]):
        raise SystemExit(f"FAIL {tag}: steps {rec['steps']} losses {rec['losses']}; want step "
                         f"{DP_TRAIN_STEPS}, finite")
    return rec, launches


def types_mesh(n: int):
    """A rank's mesh of ``n`` ranks with no process group (for a layout)."""
    return mesh_mod.LocalMesh(n, 1, 0, n, torch.device("cpu"), None, "gloo")


MOE_LAYERED_LAYERS = 4  # the layered MoE run's depth cut (full width)
# "moe numerics"' cut, batches and steps: (layers, B, S, steps), and its
# CPU sides by kind, kept for the dp-2 numerics of the same function
MOE_NUMERICS = (2, 2, 256, 2)
MOE_CPU_RUNS: dict = {}
# "moe serve"'s output, held by "moe tp serve"
MOE_SERVE_ONE: dict = {}
# both MoE serving runs: the serve host cell's sizes at 8 new tokens (a
# decode step on two gloo ranks takes ~4x one rank's)
MOE_SERVE_ARGV = ["--arch", MOE_ARCH, "--batch", "8", "--kv-slots", "4", "--kv-tier", "host",
                  "--prompt-len", "512", "--new-tokens", "8"]


def phase_moe_serve() -> tuple:
    """``launch.serve`` on full granite-moe-1b-a400m (24 layers) at the
    serve host cell's sizes but 8 new tokens (``MOE_SERVE_ARGV``): 8
    sequences through 4 device slots, prompt 512, waiting KV on the host
    tier. Counters zeroed just before and read just after; the output is
    kept for "moe tp serve"."""
    argv = MOE_SERVE_ARGV
    out, launches, wall = run_serve(argv)
    MOE_SERVE_ONE["out"] = out
    return summarize("moe serve", argv, out, launches, wall, arch=MOE_ARCH), launches


def phase_moe_layered() -> tuple:
    """``launch.train --engine zero3`` with params, grads and optimizer
    states on NVMe on granite-moe-1b-a400m at full width, its depth cut to
    ``MOE_LAYERED_LAYERS``: the layered epoch where each layer's dense row
    follows the static plan and its router-selected expert rows page as
    ("x", layer, expert) units. ``MOE_TRAIN_STEPS`` steps of 8 x 512
    tokens; counters zeroed just before and read just after. Its step
    bytes, losses and peak memory are what "moe dp2 train" halves."""
    L, steps = MOE_LAYERED_LAYERS, MOE_TRAIN_STEPS
    nvme = os.path.join(ROOT, "build", "chip_smoke_moe_layered")
    shutil.rmtree(nvme, ignore_errors=True)
    argv = ["--arch", MOE_ARCH, "--layers", str(L), "--engine", "zero3",
            "--offload-param", "nvme", "--offload-grad", "nvme", "--offload-opt", "nvme",
            "--batch", "8", "--seq", "512", "--steps", str(steps), "--lr", "3e-3",
            "--nvme-dir", nvme, "--ckpt-every", "0", "--log-every", "1"]
    trace.enable()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.train(train.build_argparser().parse_args(argv), argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    trace.disable()
    trace.clear()
    keys = ("moe_dropped_token_fraction", "expert_peak_resident_bytes",
            "expert_total_bytes", "expert_prefetch_hit_rate", "expert_evictions",
            "peak_resident_param_bytes", "param_total_bytes", "prefetch_hit_rate",
            "param_in_bytes", "param_out_bytes", "grad_out_bytes", "opt_read_bytes",
            "opt_write_bytes", "param_in_gbps", "opt_read_gbps", "opt_write_gbps")
    for m in hist["metrics"]:
        w = max(m["trace_wall_s"], 1e-12)
        say("moe layered step:", json.dumps({
            "step": m["step"], "loss": m["loss"], "grad_norm": m["grad_norm"],
            "step_s": m["step_time"], "tokens_per_s": m["tokens_per_s"],
            "compute_frac": m["trace_compute_s"] / w, "io_wait_frac": m["trace_io_wait_s"] / w,
            **{k: m[k] for k in keys}}))
    losses = hist["losses"]
    last = hist["metrics"][-1]
    rec = {"argv": " ".join(argv), "layers": L, "wall_s": wall, "launches": launches,
           "first_loss": losses[0], "last_loss": losses[-1],
           "expert_peak_resident_bytes": last["expert_peak_resident_bytes"],
           "expert_total_bytes": last["expert_total_bytes"],
           "expert_prefetch_hit_rate": last["expert_prefetch_hit_rate"],
           "expert_evictions": last["expert_evictions"],
           "moe_dropped_token_fraction": last["moe_dropped_token_fraction"],
           "nvme": hist["nvme_stats"], "losses": losses,
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "median_step_s_after_first": statistics.median(
               m["step_time"] for m in hist["metrics"][1:]),
           "step_bytes": [{k: m[k] for k in [f"{t}_bytes" for t in TIERS]
                           + ["param_total_bytes", "peak_resident_param_bytes",
                              "expert_total_bytes", "expert_peak_resident_bytes"]}
                          for m in hist["metrics"]]}
    say("moe layered:", json.dumps(rec))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL moe layered: losses not finite or not falling: {losses}")
    for m in hist["metrics"]:
        if not 0 < m["expert_peak_resident_bytes"] < m["expert_total_bytes"]:
            raise SystemExit(f"FAIL moe layered: expert residency {m['expert_peak_resident_bytes']}"
                             f" not within (0, {m['expert_total_bytes']}) at step {m['step']}")
        if not m["peak_resident_param_bytes"] < m["param_total_bytes"]:
            raise SystemExit("FAIL moe layered: every param row was resident at once")
        if not all(m[f"{t}_bytes"] > 0 for t in ("param_in", "param_out", "grad_out",
                                                  "opt_read", "opt_write")):
            raise SystemExit(f"FAIL moe layered: a tier moved no bytes at step {m['step']}")
    # per layer and step: flash forward in moe_attn, again in the backward's
    # moe_xmid and in moe_attn_vjp's recompute, one flash backward; fused
    # Adam on the three 'other' leaves (embedding, final norm, router)
    want = {"flash_attention": 3 * L * steps, "flash_attention_bwd": L * steps,
            "fused_adam": 3 * steps}
    for name, n in want.items():
        if launches[name] < n:
            raise SystemExit(f"FAIL moe layered: {name} launched {launches[name]} < {n}")
    check_main_path_routes("moe layered", launches)
    return rec, launches


def _moe_run(cfg, nvme_dir, steps, kind) -> RunConfig:
    if kind == "layered":
        return _train_run(cfg, None, nvme_dir, steps)
    shutil.rmtree(nvme_dir, ignore_errors=True)
    return RunConfig(model=cfg, parallel=make_parallel("pjit", remat="none"),
                     offload=make_offload(nvme_dir=nvme_dir),
                     train=TrainConfig(lr=3e-3, steps=steps, seed=SEED))


class RoutingRecorder:
    """Records each layer's routing plan during a MoE run: every call of
    ``moe_ffn`` (the GSPMD step, once per layer in layer order) or of
    ``moe_counts`` (the layered epoch's ``moe_attn``, once per layer in the
    forward, layer order), as each slot's token (-1 where empty). Two runs
    of the same steps record their calls in the same order, call ``i``
    being layer ``i % L``."""

    def __init__(self):
        self.plans = []
        self._saved = None

    def __enter__(self):
        self._saved = (moe_mod.moe_ffn, moe_mod.moe_counts)
        ffn, counts = self._saved

        @torch.no_grad()
        def record(router, x, cfg):
            r = moe_mod.route_tokens(router, moe_mod._groups(x, moe_mod.DEFAULT_GROUP), cfg)
            self.plans.append(torch.where(r["valid_ec"], r["tok_ec"], -1).cpu())

        def moe_ffn(p, x, cfg, *a, **kw):
            record(p["router"], x, cfg)
            return ffn(p, x, cfg, *a, **kw)

        def moe_counts(router, x, cfg, *a, **kw):
            record(router, x, cfg)
            return counts(router, x, cfg, *a, **kw)

        moe_mod.moe_ffn, moe_mod.moe_counts = moe_ffn, moe_counts
        return self

    def __exit__(self, *exc):
        moe_mod.moe_ffn, moe_mod.moe_counts = self._saved


def rerouted_experts(a: list, b: list, L: int, E: int) -> tuple:
    """(L, E) mask of the experts whose routed tokens differ between two
    runs' recorded plans in any step, and the number of slots that
    differ."""
    if len(a) != len(b):
        raise SystemExit(f"FAIL moe numerics: {len(a)} routing calls against {len(b)}")
    mask = torch.zeros(L, E, dtype=torch.bool)
    slots = 0
    for i, (pa, pb) in enumerate(zip(a, b)):
        differ = pa != pb  # (G, E, C)
        mask[i % L] |= differ.any(dim=2).any(dim=0)
        slots += int(differ.sum())
    return mask, slots


def _moe_param_groups(state, ex, kind, params=None) -> tuple:
    """(every param outside the expert rows as one f32 vector, the expert
    rows as (L * E, Pe) f32) on the CPU; ``params`` replaces the GSPMD
    state's (a mesh's gathered leaves)."""
    if kind == "layered":
        rows = ex.materialize_rows()
        other = [rows["flat"]] + pt.tree_leaves(state["other"])
        experts = rows["eflat"].float()
    else:
        params = params if params is not None else state["params"]
        moe_p = params["blocks"]["moe"]
        names = [n for n in sorted(moe_p) if n != "router"]
        L, E = moe_p["w_in"].shape[:2]
        experts = torch.cat([moe_p[n].detach().float().cpu().reshape(L * E, -1)
                             for n in names], dim=1)
        other = [pt.tree_get(params, p) for p in pt.tree_paths(params)
                 if not (p[:2] == ("blocks", "moe") and p[2] != "router")]
    return (torch.cat([t.detach().float().cpu().reshape(-1) for t in other]),
            experts.detach().float().cpu())


def phase_moe_numerics(kind: str, cfg=None, devices=("cpu", "cuda")) -> dict:
    """Full-width granite-moe-1b-a400m cut to 2 layers (``MOE_NUMERICS``): 2
    steps on the card (kernels) and on the CPU (plain versions) from the
    same weights and batches, of the GSPMD step all on the device
    (``kind="gspmd"``) or of the layered epoch on NVMe (``"layered"``); the
    CPU side is kept in ``MOE_CPU_RUNS`` for the dp-2 numerics. Loss and
    grad norm by
    ``TRAIN_TOL``; the f32 masters (in the state, or read back from the
    optimizer store) by the drift bound; every param (the layered epoch's
    rows read back from the param store, expert rows included) by it plus
    each side's bf16 rounding: ``phase_train_numerics``' bounds.

    The bulk bound (mean |diff| <= 2^-5 * sum(lr)) rests on gradients that
    differ by rounding alone. Routing is discrete: where the two sides
    round a token's k-th and (k+1)-th gates apart, or admit another token
    to a full expert, that expert's gradient differs by whole tokens'
    contributions, and its row only keeps the per-element bound. So the
    bulk bound holds the params outside the expert rows and every expert
    row whose routed tokens agree in every step; the rerouted experts
    (``RoutingRecorder``) are counted and printed. ``cfg`` and
    ``devices`` replace the model and the two sides (the tests run the
    smoke model on the CPU twice)."""
    layers, B, S, steps = MOE_NUMERICS
    cfg = cfg or dataclasses.replace(configs.get(MOE_ARCH), n_layers=layers)
    base = os.path.join(ROOT, "build", f"chip_smoke_moe_{kind}")
    init = None
    out = []
    for side, dev in enumerate(devices):
        ex = InfinityExecutor(_moe_run(cfg, os.path.join(base, str(side)), steps, kind), dev)
        if kind == "layered":
            if init is None:
                init = ex.engine.init_state(torch.Generator().manual_seed(SEED))
            state = ex.reseed(_to(init, dev))
        else:
            if init is None:
                init = ex.engine.init_params(torch.Generator().manual_seed(SEED))
            state = ex.reseed(ex.engine.adopt_params(init))
        stream = SyntheticStream(ex.input_specs(ShapeConfig("n", S, B, "train")),
                                 cfg.vocab_size, seed=SEED)
        step = ex.make_train_step()
        traj = []
        with RoutingRecorder() as rr:
            for i in range(steps):
                batch = {k: torch.from_numpy(a).to(dev) for k, a in stream.batch_at(i).items()}
                state, m = step(state, batch)
                traj.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr",
                                                      "moe_dropped_token_fraction")})
        other, experts = _moe_param_groups(state, ex, kind)
        masters = (_store_masters(ex) if kind == "layered"
                   else {keystr(p): t for p, t in zip(pt.tree_paths(state["opt"].master),
                                                      pt.tree_leaves(state["opt"].master))})
        out.append((traj, other, experts, masters, rr.plans))
        ex.close()
    if devices[0] == "cpu":
        MOE_CPU_RUNS[kind] = out[0]
    rec = {"kind": kind, "arch": cfg.arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": B, "seq": S, "steps": steps}
    return hold_moe_to_cpu("moe numerics", cfg, out[0], out[1], rec)


def hold_moe_to_cpu(tag: str, cfg, cpu: tuple, card: tuple, rec: dict) -> dict:
    """``(trajectory, params outside the expert rows, (L * E, Pe) expert
    rows, {name: f32 master}, routing plans)`` of a MoE card run against a
    CPU run of the same function, by ``phase_moe_numerics``' bounds; prints
    ``rec`` with the numbers, fails the script beyond a bound."""
    L, E = cfg.n_layers, cfg.n_experts
    kind = rec["kind"]
    (tc, o_c, x_c, m_c, plans_c), (tg, o_g, x_g, m_g, plans_g) = cpu, card
    m_c, m_g = (torch.cat([t.detach().float().cpu().reshape(-1) for t in m.values()])
                for m in (m_c, m_g))
    rerouted, slots = rerouted_experts(plans_c, plans_g, L, E)
    lrs = [t["lr"] for t in tc]
    drift = adam.parity_bound(TrainConfig(), lrs)
    mean_bound = 2**-5 * sum(lrs)
    p_c, p_g = torch.cat([o_c, x_c.reshape(-1)]), torch.cat([o_g, x_g.reshape(-1)])
    diff = (p_g - p_c).abs()
    allowed = drift + 2**-8 * (p_c.abs() + p_g.abs())
    x_diff = (x_g - x_c).abs()
    kept = ~rerouted.reshape(-1)
    bulk = torch.cat([(o_g - o_c).abs(), x_diff[kept].reshape(-1)])
    master_diff = (m_g - m_c).abs().max().item()
    rec = {**rec, "cpu": tc, "card": tg, "tol": TRAIN_TOL,
           "params_max_abs_diff": diff.max().item(), "params_mean_abs_diff": diff.mean().item(),
           "params_worst_diff_over_bound": (diff / allowed).max().item(),
           "masters_max_abs_diff": master_diff,
           "masters_worst_diff_over_drift": master_diff / drift,
           "params_max_bound": drift, "params_mean_bound": mean_bound,
           "routing_calls": len(plans_c), "rerouted_slots": slots,
           "rerouted_experts": int(rerouted.sum()), "experts": L * E,
           "bulk_mean_abs_diff": bulk.mean().item(),
           "non_expert_mean_abs_diff": (o_g - o_c).abs().mean().item(),
           "kept_expert_rows_mean_abs_diff": (x_diff[kept].mean().item()
                                              if kept.any() else None),
           "rerouted_expert_rows_mean_abs_diff": (x_diff[~kept].mean().item()
                                                  if (~kept).any() else None)}
    say(f"{tag}:", json.dumps(rec))
    for c, g in zip(tc, tg):
        for key in ("loss", "grad_norm"):
            if not abs(g[key] - c[key]) <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(c[key]):
                raise SystemExit(f"FAIL {tag} ({kind}): card {key} {g[key]} vs CPU {c[key]}")
    if not master_diff <= drift or not bool((diff <= allowed).all()) \
            or not rec["bulk_mean_abs_diff"] <= mean_bound:
        raise SystemExit(f"FAIL {tag} ({kind}): params differ beyond the bound: {rec}")
    return rec


def phase_moe_repeat() -> dict:
    """One full-width granite-moe-1b-a400m layer (the bundle cut to 1
    layer) at the training shape, loss and gradients twice on the card from
    the same weights and batch: equal bits. The combine and the dispatch's
    backward gather in a fixed order (models/moe.py), so nothing depends on
    the order atomics land in."""
    cfg = dataclasses.replace(configs.get(MOE_ARCH), n_layers=1)
    bundle = registry.build(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    stream = SyntheticStream(bundle.input_specs(ShapeConfig("r", 512, 8, "train")),
                             cfg.vocab_size, seed=SEED)
    batch = {k: torch.from_numpy(a).cuda() for k, a in stream.batch_at(0).items()}
    paths = pt.tree_paths(params)
    runs = []
    for _ in range(2):
        leaves = [pt.tree_get(params, p).detach().requires_grad_() for p in paths]
        live: dict = {}
        for p, leaf in zip(paths, leaves):
            pt.tree_set(live, p, leaf)
        loss, aux = bundle.loss_stats(live, batch)
        grads = torch.autograd.grad(loss, leaves)
        runs.append([loss.detach(), aux["moe_expert_load"]] + list(grads))
    torch.cuda.synchronize()
    differ = [("loss", "load")[i] if i < 2 else "/".join(paths[i - 2])
              for i, (a, b) in enumerate(zip(*runs)) if not torch.equal(a, b)]
    rec = {"arch": MOE_ARCH, "layers": 1, "batch": 8, "seq": 512,
           "loss": runs[0][0].item(), "leaves": len(paths), "differing": differ}
    say("moe repeat:", json.dumps(rec))
    if differ:
        raise SystemExit(f"FAIL moe repeat: a second run differs in {differ}")
    return rec


def phase_flash_window() -> dict:
    """Flash attention with a local window, forward and backward, against
    the windowed plain version (``TOL``, bf16 and f32) at ``FLASH_WINDOW``
    (bf16 timed: kernel, CUDA-core kernel, plain version, SDPA with the
    window as a boolean mask, bound over the pairs the window keeps) and
    ``FLASH_WINDOW_RAGGED``; routes held: bf16 at head_dim 256 and 64 on
    the tensor cores, f32 on the CUDA cores."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    bf16, f32 = torch.bfloat16, torch.float32
    fwd, bwd = [], []
    for i, (shape, window) in enumerate(FLASH_WINDOW + FLASH_WINDOW_RAGGED):
        timed = i < len(FLASH_WINDOW)
        for dt in (bf16, f32):
            fwd.append(check_flash(shape, dt, gen, timed and dt == bf16, window,
                                   name="flash_attention_window"))
            bwd.append(check_flash_bwd(shape, dt, gen, timed and dt == bf16, window,
                                       name="flash_attention_bwd_window"))
    check_flash_routes(fwd + bwd)
    for rec in fwd + bwd:
        say("window kernel check:", json.dumps(rec))
    return {"flash_attention_window": fwd, "flash_attention_bwd_window": bwd}


def phase_family_kernels() -> dict:
    """Flash forward and backward and the tiled matmul at the VLM's and the
    encoder-decoder's operating points (``FLASH_VLM_ENCDEC``,
    ``TILED_VLM_ENCDEC``), bf16, against their plain versions by
    ``TOL``, timed beside the bound, the plain version, the CUDA-core
    kernel and SDPA / ``torch.matmul``; every launch on the tensor cores."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    bf16 = torch.bfloat16
    fwd = [check_flash(shape, bf16, gen, timed=True, causal=causal)
           for shape, causal in FLASH_VLM_ENCDEC]
    bwd = [check_flash_bwd(shape, bf16, gen, timed=True, causal=causal)
           for shape, causal in FLASH_VLM_ENCDEC]
    check_flash_routes(fwd + bwd)
    tiled = [check_tiled_t(c, bf16, gen, timed=not c[3]) for c in TILED_VLM_ENCDEC]
    check_routes(tiled)
    for rec in fwd + bwd + tiled:
        say("family kernel check:", json.dumps(rec))
    return {"flash_attention": fwd, "flash_attention_bwd": bwd, "tiled_matmul": tiled}


def parked_seq_bytes(cfg, prompt: int, new: int) -> int:
    """One waiting sequence's parked bytes, the ``len`` placeholder
    included. A fixed-state cache is the same at any length; a VLM's K/V
    are paged up to the prompt, its vision positions among them. An
    encoder-decoder's are counted from the parked leaves: its decoder K/V
    up to the prompt's P // 4 tokens and its cross-attention K/V at the
    encoder's P frames, whole; ``sequence_kv_bytes`` would read
    ``cache_defs``, which sizes those at ``cache_len // 4``, as the
    reference's does."""
    if cfg.family == "encdec":
        row = cfg.n_dec_layers * cfg.n_kv_heads * cfg.resolved_head_dim * 2  # bf16, a position
        return 2 * row * (prompt // 4) + 2 * row * prompt + 4
    if cfg.family == "vlm":
        return kvcache.sequence_kv_bytes(cfg, prompt)
    return kvcache.sequence_kv_bytes(cfg, prompt + new)


def phase_family_serve(tag: str, arch: str, prompt: int, new: int, layers: int = 0) -> tuple:
    """``launch.serve`` on ``arch`` at full width (its depth cut to
    ``layers`` when given): 8 sequences through 4 device slots, waiting
    caches parked on the host tier, every slot at its own length. Counters
    zeroed just before and read just after."""
    argv = ["--arch", arch, "--batch", "8", "--kv-slots", "4", "--kv-tier", "host",
            "--prompt-len", str(prompt), "--new-tokens", str(new)]
    if layers:
        argv += ["--layers", str(layers)]
    cfg = configs.with_layers(configs.get(arch), layers)
    out, launches, wall = run_serve(argv)
    FAMILY_SERVE_ONE[tag] = out
    rec = summarize(tag, argv, out, launches, wall, arch=arch, cfg=cfg)
    if any(len(g) != new for g in out["generated"]):
        raise SystemExit(f"FAIL {tag}: not every sequence produced its {new} tokens")
    per_seq = parked_seq_bytes(cfg, prompt, new)
    if out["kv"]["out_bytes"] != out["admissions"] * per_seq:
        raise SystemExit(f"FAIL {tag}: parked {out['kv']['out_bytes']} B for "
                         f"{out['admissions']} caches of {per_seq} B")
    rec["n_params"] = registry.build(cfg).n_params()
    rec["cache_bytes_per_seq"] = per_seq
    say(f"{tag} summary:", json.dumps({k: rec[k] for k in (
        "n_params", "cache_bytes_per_seq", "prefill_tok_s", "decode_tok_s", "ttft_p50_s",
        "ttft_p99_s", "decode_token_p50_s", "wall_s")}))
    return rec, launches


def step_launches(cfg, remat: str, steps: int) -> dict:
    """The flash and tiled-matmul launches of ``steps`` training steps of
    ``cfg`` under ``remat``: the flash forward once per attention layer
    (twice where the backward recomputes it: ``full`` and ``dots``), its
    backward once; each MLP product forward (again under ``full``; ``dots``
    saves it), then dX and dW."""
    A, P = attention_layers(cfg), mlp_products(cfg) if cfg.family in MLP_FAMILIES else 0
    return {"flash_attention": (1 if remat == "none" else 2) * A * steps,
            "flash_attention_bwd": A * steps,
            "tiled_matmul": ((2 if remat == "full" else 1) + 2) * P * steps}


def _busy_s(prof) -> float:
    """Seconds in which the card ran any device-side event (kernels,
    copies, sets) under ``prof``: the union of their intervals."""
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return trace._total(trace._merge(spans)) / 1e6


def phase_plan_nvme(batch: int = 8, seq: int = 2048, steps: int = 2) -> tuple:
    """``launch.train --plan auto --objective min_device_mem`` on full
    seamless-m4t-medium at ``batch`` x ``seq`` frames on the detected card:
    the planner gives the GSPMD engine with params, gradients and optimizer
    states all on NVMe, so each step loads every leaf through the leaf
    scheduler, runs the gradient step on the card, drains the f32
    gradients, updates on the host (the streamed Adam) and writes the bf16
    leaves back from the host. Counters zeroed just before and read just
    after; the run under a CUDA-only profiler for the device's busy
    seconds. Checks the plan, falling finite losses, each step's byte
    counters against the leaves and the plan, the residency flag, the
    launches the plan's remat gives (all on the tensor cores) and no fused
    Adam; the fresh ``--nvme-dir`` is removed afterwards."""
    tag = "encdec plan nvme"
    cfg = configs.get(ENCDEC_ARCH)
    nvme = os.path.join(ROOT, "build", "chip_smoke_encdec_plan_nvme")
    shutil.rmtree(nvme, ignore_errors=True)
    argv = ["--arch", ENCDEC_ARCH, "--plan", "auto", "--objective", "min_device_mem",
            "--batch", str(batch), "--seq", str(seq), "--steps", str(steps), "--lr", "3e-3",
            "--nvme-dir", nvme, "--ckpt-every", "0", "--log-every", "1"]
    trace.enable()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        hist = train.train(train.build_argparser().parse_args(argv), argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    trace.disable()
    trace.clear()
    shutil.rmtree(nvme, ignore_errors=True)
    busy_s = _busy_s(prof)
    plan, run = hist["plan"], hist["run"]
    say(f"{tag} plan: {plan.summary()}")
    defs = pt.tree_leaves(registry.build(cfg).defs)
    leaf_bytes = sum(math.prod(d.shape) * d.torch_dtype.itemsize for d in defs)
    n_params = sum(math.prod(d.shape) for d in defs)
    keep = ("param_in_bytes", "param_out_bytes", "param_total_bytes", "param_in_gbps",
            "param_out_gbps", "grad_out_bytes", "grad_out_gbps", "opt_read_bytes",
            "opt_write_bytes", "opt_read_gbps", "opt_write_gbps", "nvme_pinned_peak_bytes",
            "peak_resident_param_bytes", "plan_peak_resident_param_bytes",
            "plan_residency_ok", "plan_param_step_bytes", "plan_grad_step_bytes",
            "plan_opt_step_bytes", "trace_wall_s", "trace_compute_s", "trace_io_wait_s",
            "trace_other_s")
    for m in hist["metrics"]:
        say(f"{tag} step:", json.dumps({
            "step": m["step"], "loss": m["loss"], "grad_norm": m["grad_norm"], "lr": m["lr"],
            "step_s": m["step_time"], "tokens_per_s": m["tokens_per_s"],
            "param_in_plus_out_bytes": m["param_in_bytes"] + m["param_out_bytes"],
            **{k: m[k] for k in keep if k in m}}))
    losses = hist["losses"]
    step_walls = [m["step_time"] for m in hist["metrics"]]
    rec = {"argv": " ".join(argv), "wall_s": wall, "launches": launches,
           "plan": {"engine": plan.engine, "tiers": plan.tiers, "remat": plan.remat,
                    "window": plan.prefetch_layers, "read_ahead": plan.read_ahead,
                    "pinned_buffer_mb": plan.pinned_buffer_mb, "feasible": plan.feasible,
                    "device_mem": plan.hardware.device_mem,
                    "host_mem": plan.hardware.host_mem,
                    "nvme_capacity": plan.hardware.nvme_capacity,
                    "warnings": list(plan.warnings)},
           "first_loss": losses[0], "last_loss": losses[-1], "n_params": n_params,
           "leaf_bytes": leaf_bytes, "step_walls_s": step_walls,
           "median_step_s": statistics.median(step_walls),
           "median_tokens_per_s": batch * seq / statistics.median(step_walls),
           "device_busy_s": busy_s, "device_busy_share_of_steps": busy_s / sum(step_walls),
           "nvme_pinned_peak_bytes": max(m["nvme_pinned_peak_bytes"] for m in hist["metrics"]),
           "nvme_stats": hist["nvme_stats"]}
    say(f"{tag}:", json.dumps(rec))
    if not (plan.engine == "pjit" and plan.feasible
            and (plan.param_tier, plan.grad_tier, plan.opt_tier) == ("nvme", "nvme", "nvme")):
        raise SystemExit(f"FAIL {tag}: the planner gave {plan.summary()}; this phase runs "
                         "the GSPMD engine with every state class on NVMe")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL {tag}: losses not finite or not falling: {losses}")
    for m in hist["metrics"]:
        moved = m["opt_read_bytes"] + m["opt_write_bytes"]
        if not (m["param_in_bytes"] == m["param_out_bytes"] == m["param_total_bytes"]
                == leaf_bytes and m["grad_out_bytes"] == 4 * n_params
                and moved == m["plan_opt_step_bytes"] and m["plan_residency_ok"] is True):
            raise SystemExit(f"FAIL {tag}: step {m['step']}: param in/out/total "
                             f"{m['param_in_bytes']}/{m['param_out_bytes']}/"
                             f"{m['param_total_bytes']} (leaves {leaf_bytes}), grad out "
                             f"{m['grad_out_bytes']} (f32 {4 * n_params}), opt {moved} (plan "
                             f"{m['plan_opt_step_bytes']}), residency ok "
                             f"{m.get('plan_residency_ok')}")
    want = dict(step_launches(cfg, plan.remat, steps), fused_adam=0)
    for name, n in want.items():
        if launches[name] != n:
            raise SystemExit(f"FAIL {tag}: {name} launched {launches[name]} times; want {n}")
    check_main_path_routes(tag, launches)
    return rec, launches


REMAT_POLICIES = ("none", "full", "dots")


def phase_encdec_remat(batch: int = 8, seq: int = 2048, steps: int = 3) -> dict:
    """Full seamless-m4t-medium, every state on the device, ``steps`` GSPMD
    steps of ``batch`` x ``seq`` frames under each activation checkpoint
    policy from the same weights and batches. Counters zeroed just before
    each policy's steps and read just after; the peak of
    ``torch.cuda.max_memory_allocated`` over them. Fails unless the first
    step's loss agrees across the policies by ``TRAIN_TOL``, the peaks are
    ordered none > dots > full, and each policy launches what
    ``step_launches`` gives (``dots``: the tiled matmul as under ``none``,
    flash forward as under ``full``), all on the tensor cores."""
    tag = "encdec remat"
    cfg = configs.get(ENCDEC_ARCH)
    dev = torch.device("cuda")
    params0 = registry.build(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    stream = SyntheticStream(registry.build(cfg).input_specs(
        ShapeConfig("r", seq, batch, "train")), cfg.vocab_size, seed=SEED)
    out, paths = {}, {}
    for policy in REMAT_POLICIES:
        run = RunConfig(model=cfg, parallel=make_parallel("pjit", remat=policy),
                        train=TrainConfig(lr=3e-3, steps=steps, seed=SEED))
        ex = InfinityExecutor(run, dev)
        state = ex.reseed(ex.engine.adopt_params({k: v for k, v in params0.items()}))
        step = ex.make_train_step()
        batches = [{k: torch.from_numpy(a).to(dev) for k, a in stream.batch_at(i).items()}
                   for i in range(steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses, walls = [], []
        for b in batches:
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        ex.close()
        del ex, state, step, batches
        torch.cuda.empty_cache()
        rec = {"policy": policy, "losses": losses, "step_ms": [w * 1e3 for w in walls],
               "median_step_ms_after_first": statistics.median(walls[1:]) * 1e3,
               "peak_allocated_gb": peak / 1e9, "launches": launches}
        say(f"{tag}:", json.dumps(rec))
        out[policy], paths[policy] = rec, launches
        for name, n in step_launches(cfg, policy, steps).items():
            if launches[name] != n:
                raise SystemExit(f"FAIL {tag} ({policy}): {name} launched "
                                 f"{launches[name]} times; want {n}")
        check_main_path_routes(f"{tag} ({policy})", launches)
    first = out["none"]["losses"][0]
    for policy in REMAT_POLICIES:
        got = out[policy]["losses"][0]
        if not abs(got - first) <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * abs(first):
            raise SystemExit(f"FAIL {tag}: step-1 loss {got} under {policy} vs {first} "
                             "under none")
    peaks = [out[p]["peak_allocated_gb"] for p in ("none", "dots", "full")]
    if not peaks[0] > peaks[1] > peaks[2]:
        raise SystemExit(f"FAIL {tag}: peak allocated none/dots/full {peaks} GB; want "
                         "none > dots > full")
    return out, paths


def count_hgmma(name: str) -> int:
    """Warpgroup MMA instructions (HGMMA) in a built kernel library, read
    with the toolkit's cuobjdump; fails when there are none."""
    lib = _build.lib_path(name)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    say(f"{name}: {n} HGMMA instructions in {lib.name}")
    if n == 0:
        raise SystemExit(f"FAIL {name}: the built library has no HGMMA instruction")
    return n


# the numerics phases' CPU sides, by ``CPU_RUNS``' key, in the order one
# thread computes them (``start_cpu_sides``): "gspmd numerics"' smollm,
# "recurrent numerics"' mamba2, "family numerics"' seamless, "recurrent
# numerics"' recurrentgemma (3 layers at full width, 1.7 B params, one
# step of one sequence) and "family numerics"' llava (one layer, 1.45 B
# params); ~190 s together on ``CPU_SIDE_THREADS`` of the host's 8
# threads, beside the build and the card's numerics phases (``main``).
# The last two are read once, by their phase, which drops them.
HYBRID_NUMERICS_KEY = (HYBRID_ARCH, (("n_layers", 3),), 1, 128, 1)
VLM_NUMERICS_KEY = (VLM_ARCH, tuple(sorted(VLM_NUMERICS_CUT.items())), 1, 160, 1)
CPU_SIDE_KEYS = (GSPMD_NUMERICS_KEY, SSM_NUMERICS_KEY, ENCDEC_NUMERICS_KEY,
                 HYBRID_NUMERICS_KEY, VLM_NUMERICS_KEY)
CPU_SIDES_READ_ONCE = (HYBRID_NUMERICS_KEY, VLM_NUMERICS_KEY)
CPU_SIDE_THREADS = 4


def cpu_side(key: tuple) -> tuple:
    """(in the CPU sides' thread) ``key``'s in-graph CPU side from
    ``init_params``' draw, and that draw: the phase's card side starts
    from it. No kernel runs on the CPU, so no launch counter moves, and an
    in-graph run on the CPU opens no store."""
    arch, cut = key[:2]
    params0 = init_params(dataclasses.replace(configs.get(arch), **dict(cut)))
    t0 = time.perf_counter()
    side = gspmd_side(key, "cpu", params0=params0)
    say(f"cpu sides: {json.dumps(key)} in {time.perf_counter() - t0:.1f} s")
    return side, params0


def start_cpu_sides() -> tuple:
    """``CPU_SIDE_KEYS``' CPU sides in order, in one daemon thread (a
    failing run exits without waiting for it), each's future of (its CPU
    side, its initial params) in ``CPU_RUNS``; the thread and the host
    threads torch took before. Until the join torch takes
    ``CPU_SIDE_THREADS`` (the count is the process's, not a thread's: the
    card's phases beside the thread take as many)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_SIDE_THREADS)
    CPU_RUNS.update({key: concurrent.futures.Future() for key in CPU_SIDE_KEYS})

    def run():
        for key in CPU_SIDE_KEYS:
            try:
                CPU_RUNS[key].set_result(cpu_side(key))
            except BaseException as e:  # re-raised where the result is taken
                CPU_RUNS[key].set_exception(e)

    thread = threading.Thread(target=run, name="cpu sides", daemon=True)
    thread.start()
    return thread, threads


def join_cpu_sides(thread: threading.Thread, threads: int) -> None:
    """Wait for the CPU sides' thread and give torch its ``threads`` back
    (the phases after this one have the host to themselves: they time it
    or trace); the first side that failed fails the run here."""
    thread.join()
    torch.set_num_threads(threads)
    for fut in CPU_RUNS.values():
        fut.result()


# each phase's seconds, in the order run (printed as "phase <name>: s")
PHASE_S: dict = {}


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds printed on a line of their own
    and kept in ``PHASE_S``. Then the phase's scratch directories under
    ``build/`` (``chip_smoke_*``: its NVMe stores, KV tiers and
    checkpoints, which no later phase reads; the records later phases
    read are files) are removed, so the run's disk holds one phase's
    stores at a time: the chip machine bounds the disk a run touches, and
    the stores of every phase together passed it."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_S[name] = time.perf_counter() - t0
    say(f"phase {name}: {PHASE_S[name]:.1f} s")
    build = os.path.join(ROOT, "build")
    for entry in os.scandir(build) if os.path.isdir(build) else ():
        if entry.name.startswith("chip_smoke_") and entry.is_dir():
            shutil.rmtree(entry.path, ignore_errors=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")

    cpu_sides = start_cpu_sides()
    t0 = time.perf_counter()
    built = timed("build", _build.build_all)
    say(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, rec in built.items():
        for line in rec["log"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")
    hgmma = {name: count_hgmma(name)
             for name in ("flash_attention", "tiled_matmul", "quantized_matmul")}
    # beside the CPU sides' thread, only the numerics phases: they read no
    # host clock and turn no trace on (the trace is the process's); then
    # the thread is joined, before any phase that times the host or traces
    numerics = timed("train numerics", phase_train_numerics)
    timed("train numerics q8", phase_train_numerics, "q8")
    # the three placements compute one function: the thread's CPU side
    gspmd = {p: timed(f"gspmd numerics/{p}", phase_gspmd_numerics, p)
             for p in SMOLLM_PLACEMENTS}
    # int8 quantizes the 'other' gradients: its CPU side is its own
    zero3 = {p: timed(f"zero3 numerics/{p}", phase_zero3_numerics, p,
                      keep_cpu=p == "in_graph", reuse_cpu=p in ("host", "off_graph_nvme"))
             for p in ZERO3_PLACEMENTS}
    moe_repeat = timed("moe repeat", phase_moe_repeat)
    # their CPU sides are kept for the dp-2 numerics' MoE cases
    moe_numerics = {k: timed(f"moe numerics/{k}", phase_moe_numerics, k)
                    for k in ("gspmd", "layered")}
    nvme_numerics = {p: timed(f"gspmd numerics/{p}", phase_gspmd_numerics, p, ENCDEC_ARCH,
                              B=2, S=256, tag="gspmd numerics", cut=ENCDEC_NUMERICS_CUT)
                     for p in NVME_PLACEMENTS}
    timed("cpu sides", join_cpu_sides, *cpu_sides)

    checks = timed("kernels", phase_kernels)
    e2e = timed("e2e", phase_e2e)

    kv_dir = os.path.join(ROOT, "build", "chip_smoke_kv")
    shutil.rmtree(kv_dir, ignore_errors=True)
    out, launches, wall = timed("serve host", run_serve, SERVE_ARGV)
    main_rec = summarize("host", SERVE_ARGV, out, launches, wall)
    host_serve = (out, launches)  # "serve dp2" holds its ranks' routes to this run's

    nvme_argv = ["--arch", "smollm-135m", "--batch", "3", "--kv-slots", "1",
                 "--kv-tier", "nvme", "--kv-dir", kv_dir, "--prompt-len", "128",
                 "--new-tokens", "8"]
    out, nvme_launches, wall = timed("serve nvme", run_serve, nvme_argv)
    summarize("nvme", nvme_argv, out, nvme_launches, wall)
    shutil.rmtree(kv_dir, ignore_errors=True)
    q8kv_argv = nvme_argv + ["--kv-quant", "q8"]
    out, q8kv_launches, wall = timed("serve nvme q8", run_serve, q8kv_argv)
    summarize("nvme q8", q8kv_argv, out, q8kv_launches, wall)

    train_checks = timed("train kernels", phase_train_kernels)
    train_rec, train_launches = timed("train", phase_train_main)
    q8_rec, q8_launches = timed("train q8", phase_train_main, "q8")
    plan_rec, plan_launches = timed("plan train", phase_plan_train, "plan train", [])
    offload_rec, offload_launches = timed("plan offload", phase_plan_train,
                                          "plan offload", ["--hw-device-mem", OFFLOAD_DEVICE_MEM])
    plan_serve_rec, plan_serve_launches = timed("plan serve", phase_plan_serve)
    z3_rec, z3_launches = timed(
        "zero3 train", phase_zero3_train, "zero3 train",
        ["--offload-param", "device", "--offload-opt", "device"])
    z3o_rec, z3o_launches = timed(
        "zero3 offload", phase_zero3_train, "zero3 offload",
        ["--offload-param", "device", "--offload-opt", "host"])
    z3h_rec, z3h_launches = timed(
        "zero3 host", phase_zero3_train, "zero3 host",
        ["--offload-param", "host", "--offload-opt", "host"])
    drill_rec, drill_launches = timed("resume drill", phase_resume_drill)
    moe_serve_rec, moe_serve_launches = timed("moe serve", phase_moe_serve)
    moe_plan_rec, moe_plan_launches = timed("moe plan train", phase_plan_train,
                                            "moe plan train", [], arch=MOE_ARCH)
    moe_layered_rec, moe_layered_launches = timed("moe layered", phase_moe_layered)
    # two ranks on the card: one spawn runs every dp-2 job (DP_PARTS), whose
    # records the phases below hold
    torch.cuda.empty_cache()  # the ranks' parts want the card's memory
    dp_ranks = timed("dp2 ranks", run_ranks, "all", 900)
    dp2_rec, dp2_launches = timed("zero3 dp2 numerics", phase_zero3_dp2_numerics, dp_ranks)
    dp2_train_rec, dp2_train_launches, train_ranks = timed(
        "zero3 dp2 train", phase_zero3_dp_train, train_rec, mode="train+moe", recs=dp_ranks)
    moe_dp2_rec, moe_dp2_launches = timed("moe dp2 train", phase_moe_dp_train,
                                          moe_layered_rec, train_ranks)
    gdp2, gdp2_launches = timed("gspmd dp2 numerics", phase_gspmd_dp2_numerics, dp_ranks)
    gdp2_train_rec, gdp2_train_launches, gtrain_ranks = timed(
        "gspmd dp2 train", phase_gspmd_dp_train, plan_rec, mode="gspmd_train+moe",
        recs=dp_ranks)
    gmoe_dp2_rec, gmoe_dp2_launches = timed("gspmd moe dp2 train", phase_gspmd_moe_dp_train,
                                            moe_layered_rec, gtrain_ranks)
    # "serve dp2"'s, "tp serve"'s and "cp serve"'s one-rank side
    tp_one, _, _ = timed("tp serve one rank", run_serve, TP_SERVE_ARGV)
    sdp2_rec, sdp2_launches = timed("serve dp2", phase_serve_dp2, dp_ranks, tp_one,
                                    host_serve[1])
    cp_rec, cp_launches = timed("cp numerics", phase_tp_numerics, _part(dp_ranks, "cp_numerics"),
                                "cp numerics")
    cpt_rec, cpt_launches = timed("cp train", phase_tp_train, _part(dp_ranks, "cp_train"),
                                  plan_rec, "cp train")
    # three model ranks on the card: one spawn runs every tensor-parallel job
    tp_ranks = timed("tp3 ranks", run_ranks, "tp3", 600, 3)
    tp_rec, tp_launches = timed("tp numerics", phase_tp_numerics,
                                _part(tp_ranks, "tp_numerics"), "tp numerics")
    tpt_rec, tpt_launches = timed("tp train", phase_tp_train, _part(tp_ranks, "tp_train"),
                                  plan_rec, "tp train")
    tps_rec, tps_launches = timed("tp serve", phase_tp_serve, _part(tp_ranks, "tp_serve"),
                                  tp_one)
    # the two-rank spawn's model-axis serving and MoE parts
    cps_rec, cps_launches = timed("cp serve", phase_cp_serve, _part(dp_ranks, "cp_serve"),
                                  tp_one)
    moe_mx = {s: timed(f"moe {s} numerics", phase_moe_model_axis_numerics,
                       _part(dp_ranks, f"moe_{s}_numerics"), s) for s in ("tp", "cp")}
    moe_tpt_rec, moe_tpt_launches = timed("moe tp train", phase_moe_tp_train,
                                          _part(dp_ranks, "moe_tp_train"), moe_layered_rec)
    moe_tps_rec, moe_tps_launches = timed("moe tp serve", phase_moe_tp_serve,
                                          _part(dp_ranks, "moe_tp_serve"))
    model_axis_checks = timed("model axis kernels", phase_model_axis_kernels)
    train_checks.update(timed("flash window", phase_flash_window))
    for name, recs in model_axis_checks.items():  # after the window's own shapes
        train_checks[name] += recs
    # the hybrid's 1.7 B-param cut takes one step of one sequence: its CPU
    # side is the run's slowest (109-128 s at two sequences)
    # mamba2's CPU side is held by "ssm cp numerics" too
    recurrent = {arch: timed(f"recurrent numerics/{arch}", phase_gspmd_numerics, "in_graph",
                             arch, layers, B, S, tag="recurrent numerics", steps=steps)
                 for arch, layers, B, S, steps in ((SSM_ARCH, 2, 4, 256, 2),
                                                   (HYBRID_ARCH, 3, 1, 128, 1))}
    hybrid_serve_rec, hybrid_serve_launches = timed(
        "hybrid serve", phase_family_serve, "hybrid serve", HYBRID_ARCH, 2560, 16)
    hybrid_train_rec, hybrid_train_launches = timed(
        "hybrid plan train", phase_plan_train, "hybrid plan train", [], arch=HYBRID_ARCH,
        batch=1, seq=4096, layers=HYBRID_TRAIN_LAYERS)
    ssm_serve_rec, ssm_serve_launches = timed("ssm serve", phase_family_serve,
                                              "ssm serve", SSM_ARCH, 512, 32)
    ssm_train_rec, ssm_train_launches = timed("ssm plan train", phase_plan_train,
                                              "ssm plan train", [], arch=SSM_ARCH)
    # the two-rank spawn's recurrent parts, held against the one-rank runs
    # above: mamba2 under context parallelism, recurrentgemma under tensor
    no_flash = ("flash_attention", "tiled_matmul")
    scn_rec, scn_launches = timed(
        "ssm cp numerics", phase_tp_numerics, _part(dp_ranks, "ssm_cp_numerics"),
        "ssm cp numerics", SSM_NUMERICS_KEY, "ssm_cp_numerics", "cp", ("fused_adam",), no_flash)
    sct_rec, sct_launches = timed(
        "ssm cp train", phase_tp_train, _part(dp_ranks, "ssm_cp_train"), ssm_train_rec,
        "ssm cp train", model_axis_bytes(SSM_ARCH, 0, 2), "cp", ("fused_adam",), no_flash)
    scs_rec, scs_launches = timed(
        "ssm cp serve", phase_recurrent_serve, "ssm cp serve", _part(dp_ranks, "ssm_cp_serve"),
        "ssm serve", "cp", (), no_flash)
    hybrid_cfg = configs.with_layers(configs.get(HYBRID_ARCH), HYBRID_TRAIN_LAYERS)
    htt_rec, htt_launches = timed(
        "hybrid tp train", phase_tp_train, _part(dp_ranks, "hybrid_tp_train"),
        hybrid_train_rec, "hybrid tp train",
        model_axis_bytes(HYBRID_ARCH, HYBRID_TRAIN_LAYERS, 2), "tp",
        ("flash_attention", "flash_attention_bwd", "tiled_matmul", "fused_adam"))
    check_window_launches("hybrid tp train", htt_launches, hybrid_cfg)
    FAMILY_SERVE_ONE["hybrid tp serve one rank"] = timed(
        "hybrid tp serve one rank", run_serve, HYBRID_SERVE_ARGV)[0]
    hts_rec, hts_launches = timed(
        "hybrid tp serve", phase_recurrent_serve, "hybrid tp serve",
        _part(dp_ranks, "hybrid_tp_serve"), "hybrid tp serve one rank", "tp",
        ("flash_attention", "tiled_matmul"))
    check_window_launches("hybrid tp serve", hts_launches, configs.get(HYBRID_ARCH))
    for name, recs in timed("family kernels", phase_family_kernels).items():
        train_checks[name] += recs
    # llava's 1.45 B-param cut takes one step, as the hybrid's
    family = {arch: timed(f"family numerics/{arch}", phase_gspmd_numerics, "in_graph", arch,
                          B=B, S=S, tag="family numerics", cut=cut, steps=steps)
              for arch, cut, B, S, steps in ((ENCDEC_ARCH, ENCDEC_NUMERICS_CUT, 2, 256, 2),
                                             (VLM_ARCH, VLM_NUMERICS_CUT, 1, 160, 1))}
    vlm_serve_rec, vlm_serve_launches = timed(
        "vlm serve", phase_family_serve, "vlm serve", VLM_ARCH, 3072, 16,
        layers=VLM_SERVE_LAYERS)
    vlm_train_rec, vlm_train_launches = timed(
        "vlm plan train", phase_plan_train, "vlm plan train", [], arch=VLM_ARCH, batch=1,
        seq=4096, layers=VLM_TRAIN_LAYERS)
    encdec_serve_rec, encdec_serve_launches = timed(
        "encdec serve", phase_family_serve, "encdec serve", ENCDEC_ARCH, 2048, 32)
    encdec_train_rec, encdec_train_launches = timed(
        "encdec plan train", phase_plan_train, "encdec plan train", [], arch=ENCDEC_ARCH,
        batch=8, seq=2048)
    # the two-rank spawn's encoder-decoder parts, held against the one-rank
    # runs: tensor parallelism, and context parallelism forced
    encdec_kernels = ("flash_attention", "flash_attention_bwd", "tiled_matmul", "fused_adam")
    emx = {s: timed(f"encdec {s} numerics", phase_tp_numerics,
                    _part(dp_ranks, f"encdec_{s}_numerics"), f"encdec {s} numerics",
                    ENCDEC_NUMERICS_KEY, f"encdec_{s}_numerics", s, encdec_kernels)
           for s in ("tp", "cp")}
    ett_rec, ett_launches = timed(
        "encdec tp train", phase_tp_train, _part(dp_ranks, "encdec_tp_train"),
        encdec_train_rec, "encdec tp train", model_axis_bytes(ENCDEC_ARCH, 0, 2), "tp",
        encdec_kernels)
    encdec_one = timed("encdec tp serve one rank", run_serve, ENCDEC_TP_SERVE_ARGV)[0]
    ets_rec, ets_launches = timed("encdec tp serve", phase_encdec_tp_serve,
                                  _part(dp_ranks, "encdec_tp_serve"), encdec_one)
    encdec_one = timed("encdec cp serve one rank", run_serve, ENCDEC_CP_SERVE_ARGV,
                       cfg=encdec_cp_serve_cfg(), attn_strategy="cp")[0]
    ecs_rec, ecs_launches = timed("encdec cp serve", phase_encdec_cp_serve,
                                  _part(dp_ranks, "encdec_cp_serve"), encdec_one)
    # the two-rank spawn's slow-tier parts: params on NVMe through the leaf
    # scheduler on a data mesh (bf16, then q8) and on the model axis, then
    # the checkpoint drill; the drill's and the layered dp-2 run's
    # checkpoints restored on one rank
    gnv_rec, gnv_launches = timed("gspmd nvme dp2 train", phase_gspmd_nvme_train,
                                  _part(dp_ranks, "gspmd_nvme_train"), plan_rec)
    gq8_rec, gq8_launches = timed("gspmd nvme q8 dp2 train", phase_gspmd_nvme_q8_train,
                                  _part(dp_ranks, "gspmd_nvme_q8_train"),
                                  _part(dp_ranks, "gspmd_nvme_train"))
    cpn_rec, cpn_launches = timed("cp nvme train", phase_cp_nvme_train,
                                  _part(dp_ranks, "cp_nvme_train"), plan_rec)
    drill2_rec, drill2_launches = timed("ckpt dp2 drill", phase_ckpt_drill,
                                        _part(dp_ranks, "ckpt_drill"), gtrain_ranks)
    reshard_rec, reshard_launches = timed("ckpt reshard", phase_ckpt_reshard,
                                          _part(dp_ranks, "ckpt_drill"))
    z3r_rec, z3r_launches = timed("ckpt zero3 reshard", phase_zero3_ckpt_restore, train_ranks)
    plan_nvme_rec, plan_nvme_launches = timed("encdec plan nvme", phase_plan_nvme)
    remat_recs, remat_launches = timed("encdec remat", phase_encdec_remat)

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:65"),
               "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention.cu",
                                       "none: the TPU kernel has no backward "
                                       "(src/repro/kernels/flash_attention.py:65)"),
               "tiled_matmul": ("src/repro_torch/csrc/tiled_matmul.cu",
                                "src/repro/kernels/tiled_matmul.py:60"),
               "fused_adam": ("src/repro_torch/csrc/fused_adam.cu",
                              "src/repro/kernels/fused_adam.py:47"),
               "quantized_matmul": ("src/repro_torch/csrc/quantized_matmul.cu",
                                    "src/repro/kernels/tiled_matmul.py:92"),
               "quantized_matmul_dx": ("src/repro_torch/csrc/quantized_matmul.cu",
                                       "none: the TPU kernel has no dX orientation "
                                       "(src/repro/kernels/tiled_matmul.py:92)"),
               "flash_attention_window": ("src/repro_torch/csrc/flash_attention.cu",
                                          "src/repro/kernels/flash_attention.py:65 with the "
                                          "window of src/repro/models/common.py:166 (jnp "
                                          "chunked attention, outside Pallas)"),
               "flash_attention_bwd_window": ("src/repro_torch/csrc/flash_attention.cu",
                                              "none: the TPU kernel has no backward; the "
                                              "window of src/repro/models/common.py:166")}
    serve_launches = {"flash_attention": launches, "tiled_matmul": launches}
    # each kernel's main path: the q8 training run for the quantized kernel,
    # the bf16 training run for the others
    # fused Adam's: the explicit in-graph step, where it updates the flat
    # the windowed flash kernels': the hybrid's training run (forward and
    # backward; its serving run adds forwards)
    main_launches = {**train_launches, "quantized_matmul": q8_launches["quantized_matmul"],
                     "quantized_matmul_dx": q8_launches["quantized_matmul_dx"],
                     "fused_adam": z3_launches["fused_adam"],
                     "flash_attention_window": hybrid_train_launches["flash_attention_window"],
                     "flash_attention_bwd_window":
                         hybrid_train_launches["flash_attention_bwd_window"]}
    # every main path's launch counters, each zeroed just before its run
    paths = {"train": train_launches, "train_q8": q8_launches, "serve_host": launches,
             "serve_nvme": nvme_launches, "serve_nvme_q8": q8kv_launches,
             "plan_train": plan_launches, "plan_offload": offload_launches,
             "plan_serve": plan_serve_launches, "zero3_train": z3_launches,
             "zero3_offload": z3o_launches, "zero3_host": z3h_launches,
             "zero3_dp2_numerics": dp2_launches, "zero3_dp2_train": dp2_train_launches,
             "gspmd_dp2_numerics": gdp2_launches, "gspmd_dp2_train": gdp2_train_launches,
             "moe_dp2_train": moe_dp2_launches, "gspmd_moe_dp2_train": gmoe_dp2_launches,
             "serve_dp2": sdp2_launches, "cp_numerics": cp_launches, "cp_train": cpt_launches,
             "tp_numerics": tp_launches, "tp_train": tpt_launches, "tp_serve": tps_launches,
             "cp_serve": cps_launches, "moe_tp_numerics": moe_mx["tp"][1],
             "moe_cp_numerics": moe_mx["cp"][1], "moe_tp_train": moe_tpt_launches,
             "moe_tp_serve": moe_tps_launches, "ssm_cp_numerics": scn_launches,
             "ssm_cp_train": sct_launches, "ssm_cp_serve": scs_launches,
             "hybrid_tp_train": htt_launches, "hybrid_tp_serve": hts_launches,
             "encdec_tp_numerics": emx["tp"][1], "encdec_cp_numerics": emx["cp"][1],
             "encdec_tp_train": ett_launches, "encdec_tp_serve": ets_launches,
             "encdec_cp_serve": ecs_launches, "resume_drill": drill_launches,
             "moe_serve": moe_serve_launches,
             "moe_plan_train": moe_plan_launches, "moe_layered": moe_layered_launches,
             "hybrid_serve": hybrid_serve_launches, "hybrid_plan_train": hybrid_train_launches,
             "ssm_serve": ssm_serve_launches, "ssm_plan_train": ssm_train_launches,
             "vlm_serve": vlm_serve_launches, "vlm_plan_train": vlm_train_launches,
             "encdec_serve": encdec_serve_launches,
             "encdec_plan_train": encdec_train_launches,
             "encdec_plan_nvme": plan_nvme_launches,
             "gspmd_nvme_dp2_train": gnv_launches, "gspmd_nvme_q8_dp2_train": gq8_launches,
             "cp_nvme_train": cpn_launches, "ckpt_dp2_drill": drill2_launches,
             "ckpt_reshard": reshard_launches, "ckpt_zero3_reshard": z3r_launches,
             **{f"encdec_remat_{p}": c for p, c in remat_launches.items()}}
    kernels = []
    for name in sources:
        recs = checks.get(name, []) + train_checks.get(name, [])
        # the training path's first timed shape; every other shape beside it
        head = next(r for r in train_checks[name] if "ms" in r)
        src, replaces = sources[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_launches[name],
            "path_launches": {run: c[name] for run, c in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "tol": head["tol"], "q8_run_launches": q8_launches[name], "shapes": recs}
        if "yardstick_ms" in head:
            entry["yardstick"], entry["yardstick_ms"] = head["yardstick"], head["yardstick_ms"]
        if name in ROUTED:
            entry["simt_ms"], entry["call_ms"] = head["simt_ms"], head["call_ms"]
            entry["routes"] = {run: {r: c[f"{name}_{r}"] for r in tmm.ROUTES}
                               for run, c in paths.items()}
            entry["hgmma_instructions"] = hgmma[name.removesuffix("_bwd").removesuffix("_dx")]
        if name in serve_launches:
            entry["serve_launches"] = serve_launches[name][name]
            entry["nvme_run_launches"] = nvme_launches[name]
            entry["nvme_q8_run_launches"] = q8kv_launches[name]
        kernels.append(entry)
    say(f"total: {time.perf_counter() - t_start:.1f} s "
        f"(e2e rel err {e2e['max_rel_err']:.3g}, main-path tok/s "
        f"{main_rec['decode_tok_s']:.0f} decode; train "
        f"{train_rec['first_loss']:.4f} -> {train_rec['last_loss']:.4f}, q8 "
        f"{q8_rec['first_loss']:.4f} -> {q8_rec['last_loss']:.4f}, "
        f"numerics loss {numerics['card'][-1]['loss']:.5f} card vs "
        f"{numerics['cpu'][-1]['loss']:.5f} CPU; plan train "
        f"{plan_rec['first_loss']:.4f} -> {plan_rec['last_loss']:.4f} at "
        f"{plan_rec['median_tokens_per_s_after_first']:.0f} tok/s, plan offload "
        f"{offload_rec['first_loss']:.4f} -> {offload_rec['last_loss']:.4f} at "
        f"{offload_rec['median_tokens_per_s_after_first']:.0f} tok/s; gspmd numerics "
        f"masters {max(r['masters_worst_diff_over_drift'] for r in gspmd.values()):.3f} "
        f"of drift; plan serve {plan_serve_rec['kv_tier']}x{plan_serve_rec['kv_slots']}; "
        f"zero3 {z3_rec['median_tokens_per_s_after_first']:.0f} tok/s, offload "
        f"{z3o_rec['median_tokens_per_s_after_first']:.0f} tok/s, host "
        f"{z3h_rec['median_tokens_per_s_after_first']:.0f} tok/s; zero3 numerics masters "
        f"{max(r['masters_worst_diff_over_drift'] for r in zero3.values()):.3f} of drift; "
        f"zero3 dp2 numerics masters {dp2_rec['masters_worst_diff_over_drift']:.3f} of "
        f"drift, dp2 train {dp2_train_rec['losses'][0]:.4f} -> "
        f"{dp2_train_rec['losses'][-1]:.4f} at "
        f"{dp2_train_rec['median_tokens_per_s_after_first']:.0f} tok/s (2 ranks, 1 card); "
        f"gspmd dp2 numerics params "
        f"{max(r['params_worst_diff_over_bound'] for r in gdp2.values()):.3f} of bound, "
        f"dp2 train {gdp2_train_rec['losses'][0]:.4f} -> {gdp2_train_rec['losses'][-1]:.4f} "
        f"at {gdp2_train_rec['median_tokens_per_s_after_first']:.0f} tok/s (2 ranks, 1 card); "
        f"moe dp2 train {moe_dp2_rec['losses'][0]:.4f} -> {moe_dp2_rec['losses'][-1]:.4f} at "
        f"{moe_dp2_rec['median_tokens_per_s_after_first']:.0f} tok/s, gspmd moe dp2 train "
        f"{gmoe_dp2_rec['losses'][0]:.4f} -> {gmoe_dp2_rec['losses'][-1]:.4f} at "
        f"{gmoe_dp2_rec['median_tokens_per_s_after_first']:.0f} tok/s; serve dp2 "
        f"{sdp2_rec['decode_step_ms']:.1f} ms a decode step (one rank "
        f"{sdp2_rec['one_rank_decode_step_ms']:.1f}), peak "
        + "/".join(f"{g:.2f}" for g in sdp2_rec["peak_allocated_gb"]) + " GB a rank; "
        f"tp numerics params {tp_rec['params_worst_diff_over_bound']:.3f} of bound, cp "
        f"{cp_rec['params_worst_diff_over_bound']:.3f}; tp train {tpt_rec['losses'][0]:.4f} -> "
        f"{tpt_rec['losses'][-1]:.4f} at {tpt_rec['median_tokens_per_s_after_first']:.0f} "
        f"tok/s, cp train {cpt_rec['losses'][0]:.4f} -> {cpt_rec['losses'][-1]:.4f} at "
        f"{cpt_rec['median_tokens_per_s_after_first']:.0f} tok/s (model ranks on 1 card); "
        f"tp serve {tps_rec['decode_step_ms']:.1f} ms a decode step, tokens "
        f"{tps_rec['tokens_equal_host_share']:.3f} one rank's; cp serve "
        f"{cps_rec['decode_step_ms']:.1f} ms a decode step, tokens "
        f"{cps_rec['tokens_equal_one_rank_share']:.3f} one rank's; moe tp / cp numerics "
        f"params {moe_mx['tp'][0]['params_worst_diff_over_bound']:.3f} / "
        f"{moe_mx['cp'][0]['params_worst_diff_over_bound']:.3f} of bound; moe tp train "
        f"{moe_tpt_rec['losses'][0]:.4f} -> {moe_tpt_rec['losses'][-1]:.4f} at "
        f"{moe_tpt_rec['median_tokens_per_s_after_first']:.0f} tok/s; moe tp serve "
        f"{moe_tps_rec['decode_step_ms']:.1f} ms a decode step, tokens "
        f"{moe_tps_rec['tokens_equal_one_rank_share']:.3f} one rank's; "
        f"resume drill restarts {drill_rec['restarts']}; moe repeat "
        f"{'bit-equal' if not moe_repeat['differing'] else 'DIFFERS'}, moe numerics params "
        f"{max(r['params_worst_diff_over_bound'] for r in moe_numerics.values()):.3f} of "
        f"bound; moe serve {moe_serve_rec['decode_tok_s']:.0f} decode tok/s; moe plan train "
        f"{moe_plan_rec['first_loss']:.4f} -> {moe_plan_rec['last_loss']:.4f} at "
        f"{moe_plan_rec['median_tokens_per_s_after_first']:.0f} tok/s; moe layered "
        f"{moe_layered_rec['first_loss']:.4f} -> {moe_layered_rec['last_loss']:.4f}, "
        f"expert peak {moe_layered_rec['expert_peak_resident_bytes']} of "
        f"{moe_layered_rec['expert_total_bytes']} B; recurrent numerics params "
        f"{max(r['params_worst_diff_over_bound'] for r in recurrent.values()):.3f} of bound; "
        f"hybrid serve {hybrid_serve_rec['decode_tok_s']:.0f} decode tok/s, "
        f"{hybrid_serve_rec['prefill_tok_s']:.0f} prefill tok/s, TTFT p50 "
        f"{hybrid_serve_rec['ttft_p50_s']:.3f} s; hybrid plan train "
        f"{hybrid_train_rec['first_loss']:.4f} -> {hybrid_train_rec['last_loss']:.4f} at "
        f"{hybrid_train_rec['median_tokens_per_s_after_first']:.0f} tok/s; ssm serve "
        f"{ssm_serve_rec['decode_tok_s']:.0f} decode tok/s; ssm plan train "
        f"{ssm_train_rec['first_loss']:.4f} -> {ssm_train_rec['last_loss']:.4f} at "
        f"{ssm_train_rec['median_tokens_per_s_after_first']:.0f} tok/s; ssm cp numerics params "
        f"{scn_rec['params_worst_diff_over_bound']:.3f} of bound; ssm cp train "
        f"{sct_rec['losses'][0]:.4f} -> {sct_rec['losses'][-1]:.4f} at "
        f"{sct_rec['median_step_s_after_first']:.3f} s a step; ssm cp serve "
        f"{scs_rec['decode_step_ms']:.1f} ms a decode step, tokens "
        f"{scs_rec['tokens_equal_one_rank_share']:.3f} one rank's; hybrid tp train "
        f"{htt_rec['losses'][0]:.4f} -> {htt_rec['losses'][-1]:.4f} at "
        f"{htt_rec['median_step_s_after_first']:.3f} s a step; hybrid tp serve "
        f"{hts_rec['decode_step_ms']:.1f} ms a decode step, tokens "
        f"{hts_rec['tokens_equal_one_rank_share']:.3f} one rank's; family numerics "
        f"params {max(r['params_worst_diff_over_bound'] for r in family.values()):.3f} of "
        f"bound; vlm serve {vlm_serve_rec['decode_tok_s']:.0f} decode tok/s, "
        f"{vlm_serve_rec['prefill_tok_s']:.0f} prefill tok/s, TTFT p50 "
        f"{vlm_serve_rec['ttft_p50_s']:.3f} s; vlm plan train "
        f"{vlm_train_rec['first_loss']:.4f} -> {vlm_train_rec['last_loss']:.4f} at "
        f"{vlm_train_rec['median_tokens_per_s_after_first']:.0f} tok/s; encdec serve "
        f"{encdec_serve_rec['decode_tok_s']:.0f} decode tok/s, TTFT p50 "
        f"{encdec_serve_rec['ttft_p50_s']:.3f} s; encdec plan train "
        f"{encdec_train_rec['first_loss']:.4f} -> {encdec_train_rec['last_loss']:.4f} at "
        f"{encdec_train_rec['median_tokens_per_s_after_first']:.0f} tok/s; encdec tp / cp "
        f"numerics params {emx['tp'][0]['params_worst_diff_over_bound']:.3f} / "
        f"{emx['cp'][0]['params_worst_diff_over_bound']:.3f} of bound; encdec tp train "
        f"{ett_rec['losses'][0]:.4f} -> {ett_rec['losses'][-1]:.4f} at "
        f"{ett_rec['median_step_s_after_first']:.3f} s a step; encdec tp serve "
        f"{ets_rec['decode_step_ms']:.1f} ms a decode step, tokens "
        f"{ets_rec['tokens_equal_one_rank_share']:.3f} one rank's; encdec cp serve "
        f"{ecs_rec['decode_step_ms']:.1f} ms a decode step, tokens "
        f"{ecs_rec['tokens_equal_one_rank_share']:.3f} one rank's; gspmd numerics "
        f"on NVMe params "
        f"{max(r['params_worst_diff_over_bound'] for r in nvme_numerics.values()):.3f} of "
        f"bound; gspmd nvme dp2 train {gnv_rec['losses'][0]:.4f} -> "
        f"{gnv_rec['losses'][-1]:.4f} at {statistics.median(gnv_rec['step_s']):.2f} s/step, "
        f"q8 loss gap {max(gq8_rec['loss_gap']):.3g} (bound {min(gq8_rec['loss_bound']):.3g}), "
        f"cp nvme train {cpn_rec['losses'][0]:.4f} -> {cpn_rec['losses'][-1]:.4f}; ckpt dp2 drill "
        f"restarts {drill2_rec['restarts']}, {drill2_rec['checkpoint']['bytes']} B, reshard "
        f"{reshard_rec['losses'][0]:.4f}, zero3 reshard {z3r_rec['losses'][0]:.4f}; "
        f"encdec plan nvme {plan_nvme_rec['first_loss']:.4f} -> "
        f"{plan_nvme_rec['last_loss']:.4f} at {plan_nvme_rec['median_step_s']:.2f} s/step, "
        f"busy {plan_nvme_rec['device_busy_share_of_steps']:.3f}; encdec remat peak GB "
        + ", ".join(f"{p} {r['peak_allocated_gb']:.2f}" for p, r in remat_recs.items())
        + ")")
    say("phases:", json.dumps(PHASE_S))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--nccl-check"]:
        sys.exit(nccl_check(tuple(sys.argv[2:]) or ("train", "serve", "tp")))
    sys.exit(main())

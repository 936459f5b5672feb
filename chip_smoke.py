#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ray_lightning_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (nothing is caught):

1. Build every kernel of the port from the sources in this checkout
   (``nvcc``, one process per source, all started together) and print the
   build time and the card's name and power limit. Count the tensor-core
   instructions (``HMMA``, ``HGMMA``) of each kernel in the built
   libraries' SASS (``cuobjdump -sass``): every bf16 kernel (K1, K2, K3 at
   D=64 and D=128) must have some, every fp32 kernel none.
2. Hold K1 (the forward) against its plain PyTorch version on the card, in
   bf16 and fp32, causal, non-causal, window and window + sinks, at the
   serving path's shapes (B=1, S in {16, 128, 1024}, H=12, D=64) plus a
   ragged S=40 and a D=128 shape; time the kernel, the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only:
   the port never calls it) with CUDA events, beside the kernel's bound;
   print the host microseconds of one call at S=16.
3. Hold the backward kernels K2 (dK/dV) and K3 (dQ) against
   ``flash_attention_bwd_plain`` on the same cases, in bf16 and fp32.
   Then, at the training call (B=8, S=1024, H=12, D=64, bf16, causal,
   q/k/v the strided views of the fused projection), hold K1's out/lse
   and K2/K3's dq/dk/dv against the plain versions, run K1, K2 and K3 a
   second time and require bit-for-bit equal outputs, and time K1 beside
   the SDPA forward and K2 and K3 beside the SDPA backward (yardsticks
   only) and each kernel's bound, with the achieved TFLOP/s.
4. Serve GPT-2-small width (random weights from a seeded generator, bf16)
   through ``Scheduler`` -> ``DecodeEngine``: 8 requests with prompts
   of 5 to 896 tokens, 32 new tokens each, 6 greedy and 2
   sampled (temperature 0.8, top-k 50, top-p 0.9). Every request must
   finish with its token count, the caches must stay finite, the flash
   kernel must have run once per layer per admission and the reference
   path never. Greedy requests are compared with the port's solo
   ``gpt_generate``; then a full batch decodes alone, its folds timed.
   The step that admits the 896-token prompt is timed.
5. serve-chunked: the same width through a chunked, prefix-cached,
   tiered engine (``prefill_chunk=256``, a 64-block device pool of 16
   positions, a 9 MiB host tier, a 64 MiB disk tier under
   ``build/smoke_prefix_disk``; two admissions and two chunks per step).
   Wave A: a 512-token system prompt with 6 greedy and 2 sampled
   suffixes, and an unrelated 896-token prompt prefilled in 4 chunks
   between folds; a flood of unrelated 512-token prompts; wave B: wave
   A's greedy prompts again, a flood prompt again and one never sent,
   whose admissions must hit the device pool and promote blocks from the
   host and the disk tier, and miss all three. Every request must finish
   with its 32 tokens, the caches and pool stay finite, no tier exceed
   its budget, no flash call run; pool blocks copied to the host after
   the first prefill, after wave A and after the flood must come back bit
   for bit, in the pool and in the rows they seed; each wave-B prompt's
   K/V rows in the engine must agree with the flash prefill (K1, none of
   the chunk's code) within ``KV_ROW_TOL``; greedy requests must equal the
   solo ``gpt_generate`` under ``attn_impl="reference"`` (the chunk's op
   order) except at near-ties. Prints TTFT and its queue and prefill
   shares, chunks per admission, the hit rate, each tier's counters and
   bytes, the refill time, each wave-B request's TTFT beside the same
   prompt's sent alone into an idle engine without the cache and beside
   its wave-A twin's, the tokens that differ from the flash solo, and the
   longest step while the 896-token prompt prefills beside its monolithic
   admission step in phase 4.
6. serve-paged: the same width through a paged engine (16 slots sharing
   256 usable pages of 16 positions, the K/V of 4 dense slots;
   ``prefill_chunk=256``, ``decode_fold=8``): 12 requests on one 512-token
   system prompt and 12 unrelated ones, 32-64 new tokens each, 2 sampled,
   needing more pages in all than the pool holds. Every request must
   finish with its token count; more than 4 must be resident at once, the
   scheduler must have held the queue for pages at least once and prefix
   pages must have been aliased; at idle no page may be referenced and
   the page ledger must balance; no flash call may run; greedy tokens must
   equal a dense chunked engine's (16 slots) except at near-ties. Prints
   the page stats, TTFT, and the ms of a fold with every slot decoding in
   the paged and the dense engine.
7. serve-spec: (a) the paged engine with ``spec="ngram"`` (depth 4, fold
   4) on 8 greedy and 2 sampled prompts of tiled spans, (b) a dense
   monolithic engine (8 slots, fold 4) with ``spec="model"``: a draft of
   distilgpt2's widths (GPT-2 small's embeddings, final norm and first 6
   blocks) prefilling a 32-token window per verify through the flash
   kernel. Each beside the same engine with ``spec="off"``: greedy tokens
   equal except at near-ties, sampled tokens equal; the n-gram drafter must
   have accepted tokens; (b)'s flash launches must be 12 per admission
   plus 6 per verify. K1 is then held against its plain version at the
   draft prefill's shape and timed beside SDPA and its bound. Prints the
   accept rates, tokens per verify and ms per fold beside spec="off".
   Phases 4-7 build their engines with ``pipeline=False``.
8. serve-fused: piggybacked prefill chunks, the fold-depth ladder and the
   pipelined (double-buffered) dispatch; (a) and (b) at GPT-2 small's
   width and its first ``FUSED_LAYERS`` = 6 blocks. (a) The serve-paged
   engine with ``piggyback_chunks=4``, ``fold_ladder=[1, 2, 4, 8]``, ``pipeline=True``
   on the serve-paged traffic and, 4 steps later, 4 unrelated prompts of
   768-896 tokens (one sampled) arriving while every slot decodes; the
   same engine with ``pipeline=False``, and the serve-paged engine, on the
   same traffic. Every request must finish with its token count; chunk
   rows must have ridden dispatches and two rungs at least been used; at
   idle no page referenced, the quarantine empty and the ledger balanced;
   no flash call; greedy tokens equal the serve-paged engine's except at
   near-ties, sampled tokens equal. The stream syncs of each dispatch are
   counted (``torch.cuda.set_sync_debug_mode``) over a greedy and a
   sampled batch: no dispatch may make any. (b) A dense chunked
   n-gram engine (8 slots, depth 4, fold 4, ``piggyback_chunks=2``),
   pipelined and not, on the serve-spec traffic; then a greedy request is
   cancelled while the verify after its first harvested fold is queued,
   and a new request takes its slot: none of the cancelled request's
   tokens may surface, and the new tenant's and a sampled survivor's
   tokens must equal each served alone. (c) The serve phase's engine and
   traffic with ``pipeline=True``: tokens equal the serve phase's, 12 K1
   launches per admission, K1 held against its plain version at the
   longest admission. Prints wall ms per token pipelined and not, the
   longest step while a second-wave prompt prefills beside the serve-paged
   engine's, TTFT, dispatches per rung and syncs per dispatch.
9. serve-int8: weight-only int8 through ``build_engine(int8=True)``:
   (a) the serve phase's engine and traffic on the int8 tree, beside the
   same engine on ``dequantize_params`` of it (greedy and sampled tokens
   bitwise equal) and the solo ``gpt_generate`` on the int8 tree (greedy,
   except at near-ties); (b) the draft-model spec engine with the main
   model and its 6-block self-draft int8 (``spec_draft_int8``, the draft
   read from a checkpoint written under ``build/`` and removed), whose
   tokens must be (a)'s. The int8 engine's resident weights must be at
   most 0.3x the serve phase's engine's and its int8 leaves int8 on the
   card; no dispatch may sync (greedy and sampled); K1 runs 12 times per
   admission and 6 per verify. Prints resident and graph-pool MiB,
   capture seconds, and ms per fold int8 against bf16 in turns with the
   device's idle share.
10. serve-lifecycle: the serve-chunked engine on wave A's traffic with
   every observer on (tracer, event log, journal spilling under
   ``build/smoke_journal``, a metrics registry behind ``ServeMetrics``,
   the phase ledger, a delay-only fault plan) in turns with none: tokens
   bitwise equal; each
   request's anatomy covers its latency exactly; the journal replays
   exact on a fresh engine built from its header; the registry's counters
   equal the snapshot's; no dispatch syncs with the observers on. Then a
   drain armed mid-traffic: its finishers complete, and every migrated
   request's exported blocks import into a second engine, where the
   resubmitted request is admitted warm (cold where it exported nothing)
   with the tokens of the uninterrupted run and of the
   reference-attention solo (near-ties aside). Prints ms per token with the observers on and off, the
   journal's bytes and the export/import seconds and bytes.
11. serve-fleet: the serving fleet's front door on one card. The serve
   phase's weights, written once to a checkpoint under
   ``build/smoke_fleet`` (removed after); ``fabric.init`` with
   ``RLT_REQUIRE_GPU=1``; ``start_replicas(2, num_gpus_per_replica=0.5,
   ...)`` spawns two replica actors on the one card, each loading the
   checkpoint, and ``ServeClient`` -> ``Router`` -> ``ServeReplica`` ->
   ``Scheduler`` -> ``DecodeEngine`` serves: (a) with the serve phase's
   engine, its 8 requests and the same 8 with new seeds, half through
   ``submit_many``, every stream read in a thread; then the same 16
   again, round-robin, with replica 1's folds delayed by a fault plan
   and replica 1 killed once one of its streams has a token: its
   requests fail over onto replica 0 from the client's journal; (b) with
   the serve-chunked engine and its host tier (no disk tier), the fleet
   KV plane on and one KV object store under ``build/smoke_kvstore``
   shared by both and written through: the 512-token system prompt, then
   its 8 suffixes one after another; then the warm replica's folds are
   delayed by a fault plan and it is loaded with 24 requests pinned to it,
   so the router's load weighting sends 4 new suffixes (one
   ``submit_many``) to the other replica, which must admit each through a
   peer fetch of the system prompt's 32 blocks.
   Gates: every request finishes with its count; every token of (a)
   bitwise the serve phase's in-process engine's on the same requests,
   greedy tokens equal the solo ``gpt_generate`` except at near-ties
   (sampled ones reported against it); both replicas served; every
   replica's graphs frozen and 12 K1 launches per admission (read from
   each replica's ``stats()``); every killed-replica request resubmitted,
   0 lost; (b)'s 8 suffixes routed by affinity to the warm replica with
   512 prefix tokens hit each and none on the other, tokens equal the
   reference-attention solo except at near-ties; the 4 steered suffixes
   routed to the other replica, one fetch of 32 blocks each, 512 hit
   tokens each, none timed out; after shutdown no child process and the
   card's used memory back within 256 MiB of where it was. Prints each
   replica's spawn seconds, TTFT, the fleet's tokens/s beside the serve
   phase's engine, each replica's ms per fold while both decode, the
   failover's seconds, the card's memory, and the cross-process fetch's
   kv_fetch phase seconds and MB/s.
12. serve-kvplane: the fleet KV plane and the KV object store at GPT-2
   small's width and depth. In process, two serve-chunked engines (pool
   and host tier) and a serve-paged one, each with its own ``Scheduler``
   and ``KVFleetPlane``, joined by queues: a peer fetch into the dense
   and into the paged engine (fetched blocks bitwise the holder's,
   tokens bitwise the holder's own run), a disaggregated ship whole and
   one layer per message (tokens bitwise the local run's), a layer-wise
   ship cut after 6 of 12 layers (the staged blocks abort, nothing hits,
   the request decodes cold with the same tokens), a write-through then
   a bounce onto a fresh handle of the store directory seeded from its
   manifest (warm from the store, bitwise), a session parked on one
   engine and restored on another (bitwise), and the store directory
   removed mid-fetch (cold, exact). Every receiving engine's K/V rows
   are held against K1's flash prefill of the prompt (``KV_ROW_TOL``).
   Then, on the fabric, a fresh prefill/decode fleet on serve-fleet
   (b)'s checkpoint and store: ``seed_store_directory()``, then the
   system prompt and 4 suffixes; the prefill replica admits the system
   prompt from the store and ships every request to the decode replica,
   where the client follows it; tokens equal (b)'s but at near-ties, 0
   lost, graphs frozen. Prints fetch seconds and MB/s, ship seconds
   (whole, layer-wise), store put/get seconds and bytes per block, TTFT
   by fetch, by store, cold and warm locally, and the phase's wall.
13. serve-recovery: the fleet's recovery plane on serve-fleet's
   checkpoint (removed after), the serve phase's engine in every
   replica. (a) ``start_replicas(3, num_gpus_per_replica=0.25)`` with a
   ``FleetSupervisor`` on its thread; replica 1 killed by a fault at its
   2nd fold boundary under serve-fleet's wave 1; the supervisor restarts
   it from the retained spawn recipe and a wave pinned to it follows.
   (b) The ``preempt`` fault (a 60 s grace window) on replica 0 with the
   wave pinned to it: the supervisor drains it (the residents finish
   there, the queue migrates), pre-spawns the replacement outside the
   placement group and swaps it in; a wave pinned to the replacement
   follows. (c) A one-replica fleet (a third of the card) under
   ``RouterAutoscaler(min_replicas=1, max_replicas=2)`` ticked by hand:
   the wave as a burst on slowed folds scales up through
   ``add_replica``, a wave pinned to the new replica follows, the idle
   fleet scales down through ``retire_replica``. (d) Beside (c), a head
   (``python -m ray_lightning_tpu_torch.fabric.server --port 0``) and a
   client process that starts one replica there in client mode and
   serves the wave. Gates: 0 lost; every token bitwise the serve phase's
   in-process engine's (near-ties aside); (a) the supervisor's states
   healthy -> dead -> restarting -> healthy, one restart, no failed one;
   (b) both drain sets non-empty, the routable count never below 2; (c)
   one scale up, one down, none below the minimum; (d) no process of the
   head or the client left after the head stops; every replica's graphs
   frozen and 12 K1 launches per admission; no child left and the card's
   memory back. Prints detection, kill-to-healthy, notice-to-swap, add
   and retire seconds, and the respawned, pre-spawned and added
   replicas' start-up breakdowns (process, imports, CUDA context,
   checkpoint, engine set-up, kernel load, capture).
14. Train GPT-2 small at full width and depth for 20 steps through
   ``Trainer.fit`` (B=8, S=1024, bf16 compute, flash attention, AdamW
   with warmup): every step's loss must be finite and the last below the
   first, each backward kernel must have run once per layer per step and
   the reference path never. Prints step time, tokens/s, MFU and peak
   memory.
   It then trains the same 20 steps with ``steps_per_execution=4`` (one
   CUDA graph of 4 steps per dispatch): each of its losses must equal the
   K = 1 run's step at the same boundary within 1e-3 relative, with the
   same kernel launches; prints both step times.
15. train-dist: the launched trainer (``Trainer.fit`` -> ``GPULauncher``
   -> fabric actors). (a) Phase 14's fit through ``RayStrategy(
   num_workers=1)``: one actor with the whole card, NCCL, every step a
   CUDA graph; every step's loss and the driver's recovered parameters
   must be bitwise phase 14's, each kernel launched as often as there
   (K2, K3 12 per step, the reference path never), the worker's graphs
   frozen after the first step, the checkpoint path recovered in the
   driver. (b) ``HorovodRayStrategy``, ``RayShardedStrategy(zero_stage=
   1)`` and ``zero_stage=3``, one worker each, 6 steps: losses and final
   parameters (SHA-256) bitwise (a)'s first 6, the same launches, graphs;
   between steps ZeRO-3 must hold at least 90% of the fp32 parameters'
   bytes less than ZeRO-1 (its full leaves are freed at rest), and its
   step (one CUDA graph) must hold the per-layer gathers (the capture's
   ``gather_stats``).
   (c) ``RayStrategy(num_workers=2, resources_per_worker={"GPU": 0.5})``:
   two ranks on the one card over gloo, eager, fp32, 4 layers, 4 rows per
   rank, 10 steps, against an in-process fit of the same model on 8 rows
   from the same weights: losses within 1e-4 relative, parameters within
   1e-4; both ranks on one card; the fractional-GPU and eager warnings
   seen. A callback of this script records each worker's launches, graphs,
   losses, step ends, backend, peak memory, memory allocated between steps
   and memory reserved under
   ``build/smoke_train_dist/``. Prints each fit's workers-ready seconds,
   backend, graphs, step time beside phase 14's, tokens/s and peak memory
   per rank, and the phase's wall; afterwards no child process may be
   left and the card's used memory must be within 256 MiB of before.
16. train-gspmd: tensor-parallel training through ``GSPMDStrategy``.
   Before the fits, K1 out/lse and K2/K3 dq/dk/dv are held against their
   plain versions at the tensor-parallel shape (B=8, S=1024, H=6, D=64,
   bf16, strided) and timed beside SDPA and the bound. (a) ``GSPMDStrategy(
   num_workers=1, mesh_shape={"model": 1})``, one whole-card rank on NCCL,
   graphed, 6 steps: losses and parameters (SHA-256) bitwise train-dist's
   first 6, graphs frozen after the first step. (b) two ranks sharing the
   card over gloo at ``{"model": 2}`` (6 heads and 1536 MLP columns each,
   ``wte`` whole: the vocab 50257 is odd), eager, 6 steps: each rank
   launches K1/K2/K3 12 times per step at H=6, losses within 1e-2
   relative of phase 14's, the driver's gathered parameters of phase 14's
   shapes; the fit ends with an async sharded checkpoint. (d) that
   checkpoint resumed in process on the card through ``Trainer.fit(
   ckpt_path=...)`` at its last step: step 6, parameters on the card
   bitwise (b)'s gathered ones. (c) fp32, 4 layers, 6 steps, against an
   in-process fit within 1e-4, under ``GSPMDStrategy({"model": 2})``,
   ``RayShardedStrategy(zero_stage=1)`` and ``zero_stage=3`` (gathered
   layer by layer) on two shared-card ranks, 4 rows each: ZeRO-3's peak
   allocated per rank must lie below ZeRO-1's by at least half the run's
   fp32 parameter bytes, with at most two layers alive; its reserved and
   between-step memory and its gathers and reductions (with their gloo
   seconds) are printed beside ZeRO-1's. Prints
   each fit's workers-ready seconds, backend, graphs, step time beside
   phase 14's, tokens/s, peak memory per rank, (b)'s gloo share per
   step, and the phase's wall; no child process may be left and the
   card's used memory must be within 256 MiB of before.
17. serve-mesh: tensor-parallel serving as a gang of ranks. K1 is held
   against its plain version at a rank's admission (B=1, S=1024, H=6,
   D=64, bf16, causal, strided) and timed beside SDPA and its bound. The
   serve phase's weights, written once under ``build/smoke_mesh``
   (removed after), serve through ``start_replicas(1, hosts_per_replica=2,
   mesh="2x1")``: a leader ``ServeReplica`` and a ``ServeShardFollower``
   replaying its op stream, each rank on its 6 heads and 1536 MLP
   columns, two gloo all-reduces per layer per decode iteration. (a) At
   half a card per rank, the serve phase's 8 requests: greedy tokens equal
   the serve phase's in-process engine's except at near-ties (sampled ones
   reported); both ranks' token digests equal; on every rank gloo, eager,
   ``compiled_count`` frozen, K1 12 times per admission and the reference
   path never, the KV cache's per-rank bytes half the unsplit engine's.
   (b) At a quarter
   card per rank with a ``FleetSupervisor``: a ``preempt`` fault on the
   follower under the same requests; the notice, read from the
   follower's heartbeat, drains the gang (0 lost) and a pre-spawned gang
   replaces it as a unit; the preempted and the fresh gang's tokens are
   bitwise (a)'s. (c) The gang's KV plane (``mesh_kv_run``): a gang and
   an unsplit replica on serve-fleet's chunked engine, peers of one
   another, on one KV store: the gang ships a prompt's blocks (its heads
   gathered) to the unsplit replica, the unsplit replica ships another to
   the gang, the gang parks a third into the store and the unsplit
   replica reads it back; every receiver admits warm and every greedy
   stream equals the reference-attention solo except at near-ties; the
   ships' bytes and seconds, the gang's gather seconds and each rank's K1
   launches per admission (0: the chunk code) are printed. No child
   process may be left and the card's memory must be back. Prints each
   rank's start-up, TTFT, tokens/s, ms per step, the all-reduces and gloo
   seconds per fold, the KV bytes per rank, the notice-to-swap seconds
   and the phase's wall.
18. zoo: the model zoo. (a) BERT-base masked-LM pretraining (vocab
   30522, 12 layers, 12 heads, d_model 768, S=512, bf16) through
   ``Trainer.fit(BERTEncoder(...))`` for 20 steps of 8 sequences: K1 at
   every layer of every forward (training and validation), K2 and K3 at
   every layer of every step, all non-causal, the reference path never;
   the loss falls; the graphed fit's first 4 losses bitwise those of the
   same fit with graphs off; ``fill_mask`` keeps every unmasked position
   and never emits [MASK]. Then BERT's attention call (B=8, S=512, H=12,
   D=64, bf16, non-causal, q/k/v strided views of the fused projection)
   is held against the plain versions and timed beside SDPA and the
   bound. (b) ViT-B/16 at 224 px, 10 steps of 32 images: its 197 rows
   take the reference attention (12 calls per forward), K1 never. (c)
   ResNet-18/CIFAR at width 64, fp32, 20 SGD steps of 64 images: no
   attention call, the loss falls. (b) and (c) hold fp32 logits of 2
   images within 1e-3 of the CPU forward on the same weights. (d) One
   epoch each of the XOR and MNIST fixtures: finite metrics.
19. Print the ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``. Each phase's wall seconds are printed
   as it ends.

Dispatch programs (phases 4-13): every engine captures one CUDA graph per
key of its ``dispatch_plan`` at construction; each prints its
``compiled_count``, capture seconds and graph-pool memory as it is built,
and each phase fails unless every engine it built still has that count
after its traffic. The flash launch counts are those of the replays. The
serve phase's full-batch folds and serve-fused (a) and (b) also run with
the private eager dispatch (``_graphs=False``) in turns with the graphs,
printing wall ms per fold or per token and the device's idle share.

Exits non-zero without a CUDA device, and when the package is not beside
this file.
"""
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: bf16 and fp32 peak rates (dense) and memory rate of one H100 SXM.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
MEM_BYTES_PER_S = 3.35e12
#: Kernel vs plain version: |kernel - plain| <= ATOL + RTOL * |plain|.
#: fp32: both sum in fp32 in other orders. bf16: both read the same bf16
#: inputs and round each output once; the plain versions compute in fp32
#: throughout, while the kernels round P (K1, K2, K3) and dS (K2, K3) to
#: bf16 where they enter a tensor-core product (sums stay fp32), which
#: adds up to about one more bf16 unit. lse is fp32 in both dtypes.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
LSE_TOL = 1e-3
#: Greedy engine vs solo generate: a token may differ only where the solo
#: run's top-2 logit margin is below this.
MARGIN = 1e-3
#: The chunked engine's K/V rows vs the flash prefill (K1, no chunk code):
#: the largest relative L2 error of one (layer, position) row over its
#: heads. Flash and the chunk's reference attention round differently in
#: bf16, which grows to about 0.012 by layer 12 at GPT-2-small width; a
#: chunk at wrong positions, blind to earlier chunks, seeing one row ahead
#: or writing K one row late gives 0.2 to 1.5.
KV_ROW_TOL = 0.05
#: The serve phase's requests: prompt lengths (prompts drawn from numpy
#: seed 0), which ones sample, new tokens each; and its engine.
SERVE_LENGTHS = (5, 24, 40, 96, 200, 384, 768, 896)
SERVE_SAMPLED = {0, 4}
SERVE_NEW = 32
SERVE_ENGINE = dict(num_slots=8, max_seq=1024, decode_fold=8, pipeline=False)
#: The chunked serve phase. One pool block holds 16 positions x 12 layers
#: x 12 heads x 64 x 2 bytes, for K and for V: 576 KiB. The pool holds 64
#: blocks (36 MiB), the host tier 9 MiB = 16 blocks, and the disk tier
#: 64 MiB = 113 blocks, a block's three .npy files taking 590,288 bytes.
CHUNKED_ENGINE = dict(
    num_slots=8, max_seq=1024, decode_fold=8, prefill_chunk=256,
    prefix_blocks=64, prefix_block=16, prefix_host_mb=9, prefix_disk_mb=64,
    pipeline=False,
)
CHUNKED_SCHED = dict(max_prefills_per_step=2, max_prefill_chunks_per_step=2)
#: Wave A: one 512-token system prompt (32 blocks) with a suffix of each
#: of these lengths, greedy, and two sampled ones; then a long unrelated
#: greedy prompt (896 tokens: 4 chunks).
CHUNKED_SYSTEM = 512
CHUNKED_SUFFIXES = (16, 40, 96, 130, 200, 300)
CHUNKED_SAMPLED_SUFFIXES = (24, 72)
CHUNKED_LONG = 896
#: The flood: unrelated 512-token greedy prompts (32 blocks each); wave B
#: sends the first of them again. Wave A inserts 140 blocks (the system
#: prompt's 32, the long prompt's 56, 52 of suffixes) into 64 + 16 blocks
#: of pool and host tier, so its older blocks reach the disk already. One
#: flood prompt leaves the system prompt's first 4 blocks and the last
#: suffix's newest 12 in the host tier, the rest of it in the pool, and the
#: long prompt and the other suffixes on disk. Wave B's first request then
#: promotes the system prompt from the host tier (each promotion evicts
#: the pool's least recent block, the prompt's own next one, into the host
#: tier just ahead of the walk: 32 host promotions) and its suffix from
#: the disk; the others hit the system prompt in the pool and promote
#: their suffixes from the disk (160 device hits, 46 disk promotions); the
#: flood prompt comes back from the disk (32 blocks, the last capped so the
#: final chunk runs); the prompt never sent misses. A second flood prompt
#: would push the system prompt to disk, and no wave-B block would come
#: from the host tier. tools/torch_prefix_cascade.py replays this on the
#: CPU at a tiny width, where the pool decides the same.
CHUNKED_FLOODS = 1
#: The serve-paged phase: 257 pages of 16 positions, page 0 the scratch
#: page: 256 usable pages, a 4096-token budget, 144 MiB of K/V (12 layers x
#: 12 heads x 64 x 2 bytes x 2 per position), the K/V of 4 dense slots at
#: max_seq 1024, shared by 16 slots.
PAGED_ENGINE = dict(num_slots=16, max_seq=1024, kv_page=16, kv_pages=257,
                    prefill_chunk=256, decode_fold=8, pipeline=False)
PAGED_SCHED = dict(max_prefills_per_step=16, max_prefill_chunks_per_step=4)
#: 12 requests on one 512-token system prompt with 16-64-token suffixes (its
#: 32 pages alias) and 12 unrelated prompts of 64-384 tokens, 32-64 new
#: tokens each; these two sample.
PAGED_SYSTEM = 512
PAGED_SAMPLED = ("a3", "u5")
#: The serve-spec phase: (a) the paged engine with the n-gram drafter on
#: prompts of tiled spans, (b) a dense monolithic engine with a draft model
#: of distilgpt2's widths: GPT-2 small's embeddings, final norm and first 6
#: blocks. Both beside the same engine with spec="off".
SPEC_DEPTH = 4
SPEC_FOLD = 4
SPEC_WINDOW = 32
SPEC_DRAFT_LAYERS = 6
SPEC_NEW = 48
SPEC_MODEL_ENGINE = dict(num_slots=8, max_seq=1024, decode_fold=SPEC_FOLD,
                         pipeline=False)
SPEC_SCHED = dict(max_prefills_per_step=2, max_prefill_chunks_per_step=2)
#: The serve-fused phase: (a) the serve-paged engine with piggybacked chunks,
#: the fold ladder and the pipelined dispatch, on the serve-paged traffic
#: and, FUSED_AFTER scheduler steps later, a second wave of long prompts
#: (FUSED_WAVE2 tokens each, numpy seed 3, the first sampled) arriving while
#: every slot decodes; (b) a dense chunked n-gram engine with piggybacked
#: chunks on the serve-spec traffic, and a cancel racing a verify in flight;
#: (c) the serve phase's engine and traffic with the pipelined dispatch.
FUSED_PAGED_ENGINE = dict(PAGED_ENGINE, piggyback_chunks=4,
                          fold_ladder=[1, 2, 4, 8], pipeline=True)
FUSED_AFTER = 4
FUSED_WAVE2 = (768, 897)
FUSED_SPEC_ENGINE = dict(num_slots=8, max_seq=1024, prefill_chunk=256,
                         decode_fold=SPEC_FOLD, spec="ngram",
                         spec_depth=SPEC_DEPTH, piggyback_chunks=2,
                         pipeline=True)


#: Engines built by the current phase, with their compiled_count at
#: construction (checked and dropped at the end of the phase).
ENGINES = []


def new_engine(params, cfg, **kw):
    """A ``DecodeEngine``, registered for the phase's check."""
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine

    return register_engine(DecodeEngine(params, cfg, **kw),
                           graphs=kw.get("_graphs", True))


def register_engine(engine, graphs: bool = True):
    """Print an engine's graphs' count, capture seconds and pool memory,
    and register it for the phase's check (``check_engines``)."""
    import torch

    graphs = graphs and engine.device.type == "cuda"
    if graphs and engine.compiled_count != len(engine.dispatch_plan):
        fail(f"{engine.compiled_count} graphs for a plan of "
             f"{len(engine.dispatch_plan)} keys")
    print(f"[graphs] engine {len(ENGINES)}: compiled_count "
          f"{engine.compiled_count}, capture {engine.capture_s:.3f} s, graph "
          f"pool {engine.graph_bytes / 2**20:.1f} MiB, plan "
          f"{sorted({k[0] for k in engine.dispatch_plan})}, "
          f"{'graphs' if graphs else 'eager'}")
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    ENGINES.append((engine, engine.compiled_count))
    return engine


def check_engines(phase: str) -> dict:
    """Fail unless every engine the phase built kept its compiled_count
    through its traffic; returns the phase's totals and drops the
    engines."""
    for i, (engine, n) in enumerate(ENGINES):
        if engine.compiled_count != n:
            fail(f"{phase}: engine {i} compiled_count moved from {n} to "
                 f"{engine.compiled_count} after construction")
    out = {"engines": len(ENGINES),
           "graphs": sum(n for _, n in ENGINES),
           "capture_s": sum(e.capture_s for e, _ in ENGINES),
           "graph_mib": sum(e.graph_bytes for e, _ in ENGINES) / 2**20}
    print(f"[graphs] {phase}: {json.dumps(out)}, every compiled_count "
          "unchanged after the traffic")
    ENGINES.clear()
    return out


def fold_device_ms(engine, k: int) -> float:
    """Device ms of one replay of ``engine``'s greedy rung-``k`` fold
    (the work does not depend on which slots are active)."""
    prog = engine._programs[engine._fold_key(k, False)]
    return cuda_ms(prog, iters=5, warmup=1)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds of one call of ``fn``: CUDA events around
    ``iters`` calls after ``warmup``. The stream is first held behind a
    spin kernel that outlasts twice the host's time for the ``iters``
    calls, so every launch is queued before the first event fires and the
    events time the device's work, not the host's enqueue."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # One call with its device work is an upper bound of its host time;
    # the spin is counted in cycles of a clock of at most 2 GHz.
    spin_s = 2.0 * iters * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sass_tensor_ops(path) -> dict:
    """Tensor-core instructions (``HMMA``, ``HGMMA``) per kernel function
    in the SASS of a built library, read with ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(r"\b(HMMA|HGMMA)\b", line):
            counts[fn] += 1
    return counts


def phase_build():
    """Build every source; return the tensor-core instruction count of the
    D=64 bf16 kernels, by kernel name (K1 ``flash_fwd``, K2, K3)."""
    from ray_lightning_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"[build] kernels {_build.kernel_sources()} built in "
          f"{time.perf_counter() - t0:.3f} s into {_build.BUILD_DIR}")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {name}: {line.strip()}")
    counts = {}
    for src in ("flash_fwd", "flash_bwd"):
        for fn, n in sorted(sass_tensor_ops(paths[src]).items()):
            print(f"[build] {src} SASS tensor-core instructions {n}: {fn}")
            counts[fn] = n
    tc = {}
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        for d in (64, 128):
            hits = [n for fn, n in counts.items()
                    if f"{name}_bf16_kernel" in fn and f"ILi{d}E" in fn]
            if len(hits) != 1 or hits[0] == 0:
                fail(f"the bf16 {name} kernel (D={d}) has no tensor-core "
                     f"instruction in its SASS: {hits}")
            simt = [n for fn, n in counts.items()
                    if f"{name}_kernel" in fn and f"ILi{d}E" in fn]
            if len(simt) != 1 or simt[0] != 0:
                fail(f"the fp32 {name} kernel (D={d}) should be SIMT only: "
                     f"tensor-core instructions {simt}")
            if d == 64:
                tc[name] = hits[0]
    print(f"[card] {card_line()}")
    return tc


def flash_bound(q, window, sinks, causal):
    """(bound_ms, bound_by, flops) of K1: each input read once and each
    output written once over the memory rate; 4*D FLOPs per visible
    (query, key) pair (QK^T and PV) over the peak rate of the input
    type."""
    import torch

    from ray_lightning_tpu_torch.ops.attention import band_allowed

    B, S, H, D = q.shape
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    pairs = (
        int(band_allowed(rows, cols, window, sinks).sum()) if causal else S * S
    )
    flops = 4.0 * D * pairs * B * H
    nbytes = 4 * q.numel() * q.element_size() + B * H * S * 4
    dtype = str(q.dtype).replace("torch.", "")
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / MEM_BYTES_PER_S
    bound_by = "operations" if t_ops > t_mem else "bytes"
    return max(t_ops, t_mem) * 1e3, bound_by, flops


def host_us(fn, n: int = 200) -> float:
    """Host microseconds of one call of ``fn`` (the enqueue, not the
    device's work): ``n`` calls back to back after one warm-up, read
    before the device is synchronised."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from ray_lightning_tpu_torch.ops.flash_attention import (
        _flash_fwd_cuda,
        flash_attention_plain,
    )

    shapes = [
        (1, 16, 12, 64), (1, 128, 12, 64), (1, 1024, 12, 64),
        (1, 40, 12, 64), (1, 256, 8, 128),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    timed = None
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        atol, rtol = TOL[dname]
        for B, S, H, D in shapes:
            q, k, v = (
                torch.randn((B, S, H, D), generator=gen, device="cuda")
                .to(dtype) for _ in range(3)
            )
            window = max(5, S // 4)
            for causal, w, s in (
                (True, 0, 0), (False, 0, 0), (True, window, 0),
                (True, window, 4),
            ):
                scale = D ** -0.5
                out, lse = _flash_fwd_cuda(q, k, v, causal, scale, w, s)
                ref, ref_lse = flash_attention_plain(q, k, v, causal, scale, w, s)
                torch.cuda.synchronize()
                if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
                    fail(f"non-finite kernel output {dname} {(B, S, H, D)}")
                err = (out.float() - ref.float()).abs()
                lse_err = float((lse - ref_lse).abs().max())
                ok = bool((err <= atol + rtol * ref.float().abs()).all())
                print(f"[kernel] flash_fwd {dname} B={B} S={S} H={H} D={D} "
                      f"causal={causal} window={w} sinks={s} "
                      f"max_abs_err={float(err.max())} lse_err={lse_err} "
                      f"tol=({atol}+{rtol}*|ref|, lse {LSE_TOL})")
                if not ok or lse_err > LSE_TOL:
                    fail(f"flash_fwd disagrees with its plain version "
                         f"({dname}, {(B, S, H, D)}, causal={causal}, "
                         f"window={w}, sinks={s})")
                worst[dname] = max(worst[dname], float(err.max()))
            if dtype == torch.bfloat16 and D == 64 and S in (16, 128, 1024):
                # The serving path's call: causal self-attention, bf16.
                scale = D ** -0.5
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                row = {
                    "S": S,
                    "ms": cuda_ms(
                        lambda: _flash_fwd_cuda(q, k, v, True, scale, 0, 0)
                    ),
                    "plain_ms": cuda_ms(
                        lambda: flash_attention_plain(q, k, v, True, scale)
                    ),
                    "library_ms": cuda_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True
                        )
                    ),
                }
                row["bound_ms"], row["bound_by"], flops = flash_bound(
                    q, 0, 0, True
                )
                row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
                print(f"[kernel] flash_fwd timing bf16 causal B={B} S={S} "
                      f"H={H} D={D}: {json.dumps(row)}")
                if S == 16:
                    # At serving's short buckets the host's cost of a call,
                    # not the kernel, sets the time.
                    short_us = host_us(
                        lambda: _flash_fwd_cuda(q, k, v, True, scale, 0, 0)
                    )
                    print(f"[kernel] flash_fwd host time of one call at "
                          f"S=16: {short_us} us")
                timed = row
    timed["host_us_s16"] = short_us
    return worst, timed


def bwd_inputs(B, S, H, D, dtype, gen, causal, window, sinks):
    """q, k, v, dO on the card and the forward's out and lse from K1: the
    inputs K2 and K3 are given on the main path."""
    import torch

    from ray_lightning_tpu_torch.ops.flash_attention import _flash_fwd_cuda

    q, k, v, do = (
        torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        for _ in range(4)
    )
    out, lse = _flash_fwd_cuda(q, k, v, causal, D ** -0.5, window, sinks)
    return q, k, v, do, out, lse


def training_bwd_inputs(gen, heads: int = 0):
    """The attention inputs of one GPT-2-small training layer on the card:
    q, k, v from the port's own fused projection (``gpt._project_qkv``),
    so they are the strided (B, S, 3, H, D) views the training path hands
    K1, K2 and K3 (seq stride 3*H*D, batch stride S*3*H*D); a contiguous
    dO; out and lse from K1. ``heads``: a tensor-parallel rank's local
    heads (H/m; the projection's views then have seq stride 3*(H/m)*D)."""
    import torch

    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.ops.flash_attention import _flash_fwd_cuda

    cfg = gpt.GPTConfig.gpt2_small()
    B, S, H, D, dm = (8, cfg.max_seq, heads or cfg.n_head, cfg.head_dim,
                      cfg.d_model)
    dt = torch.bfloat16
    a = torch.randn((B, S, dm), generator=gen, device="cuda").to(dt)
    lp = {
        "wqkv": (torch.randn((dm, 3, H, D), generator=gen, device="cuda")
                 * dm ** -0.5).to(dt),
        "bqkv": torch.zeros((3, H, D), device="cuda", dtype=dt),
    }
    with torch.no_grad():
        q, k, v = gpt._project_qkv(a, lp, cfg, dt)
    do = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
    out, lse = _flash_fwd_cuda(q, k, v, True, D ** -0.5, 0, 0)
    return q, k, v, do, out, lse


def check_training_call(fa, q, k, v, do, out, lse, scale, causal=True):
    """K1's out/lse and K2/K3's dq/dk/dv at the training call against the
    plain versions on the same inputs; fails on a miss."""
    import torch

    B, S, H, D = q.shape
    atol, rtol = TOL["bfloat16"]
    mode = "causal" if causal else "non-causal"
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal, scale)
    got = fa._flash_bwd_cuda(q, k, v, out, lse, do, causal, scale, 0, 0)
    again = fa._flash_bwd_cuda(q, k, v, out, lse, do, causal, scale, 0, 0)
    ref_grads = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                             scale)
    torch.cuda.synchronize()
    # One writer per gradient tile and no atomics: a repeat is bitwise equal.
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
            fail(f"{name} differs between two runs of the backward kernels "
                 f"on the same inputs")
    errs = {"lse": float((lse - ref_lse).abs().max())}
    if not errs["lse"] <= LSE_TOL:
        fail(f"flash_fwd lse disagrees at the training call: {errs['lse']}")
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out,) + got,
                          (ref,) + ref_grads):
        if not torch.isfinite(a).all():
            fail(f"non-finite {name} at the training call")
        err = (a.float() - b.float()).abs()
        errs[name] = float(err.max())
        if not bool((err <= atol + rtol * b.float().abs()).all()):
            fail(f"{name} disagrees with its plain version at the training "
                 f"call (B={B}, S={S}, H={H}, D={D}, bf16, {mode}, strided "
                 f"q/k/v): max abs err {errs[name]}")
    print(f"[kernel] training call bf16 {mode} B={B} S={S} H={H} D={D}, q/k/v "
          f"strides {q.stride()}/{k.stride()}/{v.stride()}: max abs err "
          f"{json.dumps(errs)} tol=({atol}+{rtol}*|ref|, lse {LSE_TOL})")


def bwd_bound(q, causal, n_products, out_tensors):
    """(bound_ms, bound_by, flops) of one backward kernel: q, k, v, dO read
    once, lse and delta (fp32) read once, its outputs written once, over
    the memory rate; ``n_products`` products of 2*D FLOPs per visible
    (query, key) pair over the peak rate of the input type."""
    B, S, H, D = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = n_products * 2.0 * D * pairs * B * H
    nbytes = (4 + out_tensors) * q.numel() * q.element_size() + 2 * B * H * S * 4
    dtype = str(q.dtype).replace("torch.", "")
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / MEM_BYTES_PER_S
    bound_by = "operations" if t_ops > t_mem else "bytes"
    return max(t_ops, t_mem) * 1e3, bound_by, flops


def phase_bwd_kernels():
    """K2 (dK/dV) and K3 (dQ) against ``flash_attention_bwd_plain`` on the
    card over the K1 cases, then timed at the training shape."""
    import importlib

    import torch

    # The ops package re-exports the function under the module's name.
    fa = importlib.import_module("ray_lightning_tpu_torch.ops.flash_attention")
    shapes = [
        (1, 16, 12, 64), (1, 128, 12, 64), (1, 1024, 12, 64),
        (1, 40, 12, 64), (1, 256, 8, 128),
    ]
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        atol, rtol = TOL[dname]
        for B, S, H, D in shapes:
            window = max(5, S // 4)
            for causal, w, s in (
                (True, 0, 0), (False, 0, 0), (True, window, 0),
                (True, window, 4),
            ):
                q, k, v, do, out, lse = bwd_inputs(
                    B, S, H, D, dtype, gen, causal, w, s
                )
                scale = D ** -0.5
                got = fa._flash_bwd_cuda(q, k, v, out, lse, do, causal, scale,
                                         w, s)
                ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                   causal, scale, w, s)
                torch.cuda.synchronize()
                errs = []
                for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                    if not torch.isfinite(a).all():
                        fail(f"non-finite {name} {dname} {(B, S, H, D)}")
                    err = (a.float() - b.float()).abs()
                    if not bool((err <= atol + rtol * b.float().abs()).all()):
                        fail(f"flash_bwd {name} disagrees with its plain "
                             f"version ({dname}, {(B, S, H, D)}, causal="
                             f"{causal}, window={w}, sinks={s}): max abs "
                             f"err {float(err.max())}")
                    errs.append(float(err.max()))
                worst[dname] = max(worst[dname], *errs)
                n_cases += 1
                print(f"[kernel] flash_bwd {dname} B={B} S={S} H={H} D={D} "
                      f"causal={causal} window={w} sinks={s} max_abs_err "
                      f"dq={errs[0]} dk={errs[1]} dv={errs[2]} "
                      f"tol=({atol}+{rtol}*|ref|)")
    print(f"[kernel] flash_bwd: {n_cases} cases held against the plain "
          f"version; worst bf16 {worst['bfloat16']}, fp32 {worst['float32']}")

    # The training call: B=8, H=12, S=1024, D=64, bf16, causal, with q/k/v
    # the strided views of the fused projection that gpt_forward gives the
    # kernels. Held against the plain versions first, then timed.
    q, k, v, do, out, lse = training_bwd_inputs(gen)
    scale = q.shape[-1] ** -0.5
    check_training_call(fa, q, k, v, do, out, lse, scale)
    rows = {"flash_fwd": time_fwd_training_call(fa, q, k, v, out, lse, scale)}
    rows.update(time_bwd_training_call(fa, q, k, v, do, out, lse, scale))
    return worst, rows


def time_bwd_training_call(fa, q, k, v, do, out, lse, scale,
                           causal=True) -> dict:
    """K2 and K3 timed at a training call beside the plain backward and
    the SDPA backward on the same views, with their bounds."""
    import torch
    import torch.nn.functional as F

    B, S, H, D = q.shape
    rows = {}
    dq, dk, dv = (
        torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3)
    )
    args = fa.prepare_bwd(q, k, v, out, lse, do, causal, scale, 0, 0)
    qt, kt, vt = (
        x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)
    )
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    plain_ms = cuda_ms(
        lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                             scale), iters=5, warmup=1
    )
    library_ms = cuda_ms(
        lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                    retain_graph=True)
    )
    for name, fn, n_products, n_out in (
        ("flash_bwd_dkv", lambda: fa.launch_bwd_dkv(args, dk, dv), 4, 2),
        ("flash_bwd_dq", lambda: fa.launch_bwd_dq(args, dq), 3, 1),
    ):
        row = {"ms": cuda_ms(fn), "plain_ms": plain_ms,
               "library_ms": library_ms}
        row["bound_ms"], row["bound_by"], flops = bwd_bound(
            q, causal, n_products, n_out
        )
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        rows[name] = row
        mode = "causal" if causal else "non-causal"
        print(f"[kernel] {name} timing bf16 {mode} B={B} S={S} H={H} D={D}: "
              f"{json.dumps(row)} (plain_ms and library_ms are the whole "
              f"backward: dq, dk and dv)")
    return rows


def time_fwd_training_call(fa, q, k, v, out, lse, scale, causal=True):
    """K1 at the training call: a second run must give bitwise-equal
    out/lse (one writer per output tile); then its time beside the plain
    version, the SDPA forward on the same strided views (a yardstick only)
    and its bound."""
    import torch
    import torch.nn.functional as F

    again = fa._flash_fwd_cuda(q, k, v, causal, scale, 0, 0)
    torch.cuda.synchronize()
    if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
        fail("flash_fwd out/lse differ between two runs on the same inputs")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    with torch.no_grad():
        row = {
            "ms": cuda_ms(
                lambda: fa._flash_fwd_cuda(q, k, v, causal, scale, 0, 0)
            ),
            "plain_ms": cuda_ms(
                lambda: fa.flash_attention_plain(q, k, v, causal, scale),
                iters=5, warmup=1),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=causal)
            ),
        }
    row["bound_ms"], row["bound_by"], flops = flash_bound(q, 0, 0, causal)
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
    B, S, H, D = q.shape
    mode = "causal" if causal else "non-causal"
    print(f"[kernel] flash_fwd timing at the training call bf16 {mode} B={B} "
          f"S={S} H={H} D={D}, strided q/k/v: {json.dumps(row)} (library_ms:"
          f" the SDPA forward on the same views)")
    return row


def kv_row_err(got, want) -> float:
    """Largest relative L2 error over (layer, position) rows of K or V
    caches (L, P, Hkv, hd)."""
    import torch

    g, w = got.float(), want.float()
    norm = w.norm(dim=(-2, -1)).clamp_min(torch.finfo(torch.float32).tiny)
    return ((g - w).norm(dim=(-2, -1)) / norm).max().item()


def greedy_margin(params, cfg, tokens):
    """Top-2 logit margin of the next token after ``tokens``."""
    import torch

    from ray_lightning_tpu_torch.models import gpt

    with torch.no_grad():
        h, _, _ = gpt.gpt_prefill(
            params, cfg, torch.tensor([tokens], device="cuda")
        )
        norm = gpt._make_norm(cfg)
        h = norm(h[:, -1:], params["lnf_g"], params["lnf_b"])[:, 0]
        logits = gpt._lm_head(h, gpt._head_weight(params, cfg))
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


def phase_serve():
    import numpy as np
    import torch

    from ray_lightning_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init_gpt_params(
        torch.Generator(device="cuda").manual_seed(0), cfg
    )
    t0 = time.perf_counter()
    engine = new_engine(params, cfg, device="cuda", **SERVE_ENGINE)
    torch.cuda.synchronize()
    print(f"[serve] engine built in {time.perf_counter() - t0:.3f} s, "
          f"buckets {engine.prefill_buckets}")
    lengths, n_new, sampled = SERVE_LENGTHS, SERVE_NEW, SERVE_SAMPLED
    rng = np.random.default_rng(0)
    reqs = serve_workload(cfg.vocab_size, rng)
    run = serve_run(engine, reqs)
    launches, ref_calls = run["launches"], run["reference"]
    toks, wall, admit_step_s = run["toks"], run["wall"], run["admit_step_s"]
    sched = run["sched"]
    if not (torch.isfinite(engine._k).all() and torch.isfinite(engine._v).all()):
        fail("non-finite values in the KV cache")
    admissions = sched.metrics.admitted
    print(f"[serve] {len(reqs)} requests, {admissions} admissions, "
          f"flash launches {launches}, reference-path calls {ref_calls}, "
          f"wall {wall:.3f} s")
    if launches != admissions * cfg.n_layer or ref_calls != 0:
        fail(f"flash launches {launches} != admissions x layers "
             f"{admissions * cfg.n_layer}, or reference calls {ref_calls}")

    near_ties = 0
    for i, (rid, prompt, _) in enumerate(reqs):
        if i in sampled:
            continue
        solo = gpt.gpt_generate(params, cfg, [prompt], n_new, device="cuda")
        solo = solo[0, len(prompt):].tolist()
        if toks[rid] == solo:
            continue
        j = next(j for j, (a, b) in enumerate(zip(toks[rid], solo)) if a != b)
        margin = greedy_margin(params, cfg, prompt + solo[:j])
        print(f"[serve] {rid}: engine and solo differ first at token {j}, "
              f"solo top-2 margin {margin}")
        if margin >= MARGIN:
            fail(f"{rid}: greedy mismatch at token {j} with margin {margin}")
        near_ties += 1
    print(f"[serve] greedy vs solo gpt_generate: {len(lengths) - len(sampled)}"
          f" requests, mismatches at near-ties (margin < {MARGIN}): "
          f"{near_ties}")
    snap = sched.metrics.snapshot()

    # Decode alone: a full batch of short prompts, folds timed on the host
    # clock (each step ends in its token-block read, a device sync), with
    # the graphs and with the eager dispatch in turns.
    eager = new_engine(params, cfg, device="cuda", _graphs=False,
                       **SERVE_ENGINE)
    prompts = [rng.integers(0, cfg.vocab_size, 16).tolist()
               for _ in range(engine.num_slots)]
    runs = [decode_alone(e, prompts)
            for e in (engine, eager, eager, engine)]
    dev_ms = fold_device_ms(engine, engine.decode_fold)
    graph_ms = [r[0] for r in (runs[0], runs[3])]
    eager_ms = [r[0] for r in runs[1:3]]
    decode = {
        "ms_per_fold": graph_ms,
        "ms_per_fold_eager": eager_ms,
        "device_ms_per_fold": dev_ms,
        "idle_share": [1 - dev_ms / t for t in graph_ms],
        "idle_share_eager": [1 - dev_ms / t for t in eager_ms],
        "tokens_per_s": [r[1] for r in (runs[0], runs[3])],
        "tokens_per_s_eager": [r[1] for r in runs[1:3]],
        "fold": engine.decode_fold,
        "slots": engine.num_slots,
    }
    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams

    decode["graph_vs_eager_near_ties"] = compare_greedy(
        "serve decode-alone graphs vs eager",
        [(f"d{i}", p, SamplingParams(max_new_tokens=1))
         for i, p in enumerate(prompts)],
        runs[0][2], runs[1][2], params, cfg)
    serve = {
        "ttft_p50_s": snap["ttft_p50_s"],
        "ttft_max_s": snap["ttft_max_s"],
        "tokens_per_s": snap["tokens_per_sec"],
        "wall_s": wall,
        "decode_only": decode,
        "near_tie_mismatches": near_ties,
        "admit_step_s_longest_prompt": admit_step_s,
        "longest_prompt": lengths[-1],
    }
    print(f"[serve] {json.dumps(serve)} on {card_line()}")
    return launches, admit_step_s, run


def decode_alone(engine, prompts) -> tuple:
    """Every slot of ``engine`` decoding one of ``prompts`` for 4 folds
    after the first: (host ms per fold, tokens per s, the tokens)."""
    toks = {}
    for s, prompt in enumerate(prompts):
        _, tok, _ = engine.admit(prompt, request_id=f"d{s}",
                                 max_new_tokens=4 * engine.decode_fold + 1)
        toks[f"d{s}"] = [tok]
    engine.step()
    fold_s = []
    while engine.num_active:
        t0 = time.perf_counter()
        out = engine.step()
        fold_s.append((time.perf_counter() - t0, len(out)))
        for _, rid, tok, _ in out:
            toks.setdefault(rid, []).append(tok)
    total = sum(t for t, _ in fold_s)
    return (1e3 * total / len(fold_s), sum(n for _, n in fold_s) / total,
            toks)


def serve_workload(vocab: int, rng) -> list:
    """The serve phase's requests, drawn from ``rng`` (numpy seed 0, whose
    stream the phase goes on drawing from). The greedy
    prompts have lengths at which the solo gpt_generate's prefill takes the
    flash kernel too (the shape rule sends other lengths to the reference,
    whose bf16 probabilities round differently), so solo and engine share
    their attention arithmetic. The two sampled ones have unaligned
    lengths."""
    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams

    reqs = []
    for i, n in enumerate(SERVE_LENGTHS):
        prompt = rng.integers(0, vocab, n).tolist()
        sp = (
            SamplingParams(max_new_tokens=SERVE_NEW, temperature=0.8,
                           top_k=50, top_p=0.9, seed=i)
            if i in SERVE_SAMPLED else SamplingParams(max_new_tokens=SERVE_NEW)
        )
        reqs.append((f"r{i}", prompt, sp))
    return reqs


def serve_run(engine, reqs) -> dict:
    """The serve phase's traffic through a monolithic engine: every request
    sent at once, the scheduler stepped by hand to time the step that
    admits the longest prompt. Fails unless every request finishes with its
    token count. Returns the tokens, the wall seconds, that step's seconds,
    the flash launches and reference calls counted over the run (counts
    set to 0 just before it) and the scheduler."""
    import torch

    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    sched = Scheduler(engine)
    counters.reset()
    t0 = time.perf_counter()
    for rid, prompt, sp in reqs:
        sched.submit(prompt, sp, request_id=rid)
    longest, admit_step_s = reqs[-1][0], None
    events = []
    while sched.has_work():
        ts = time.perf_counter()
        step_events = sched.step()
        step_s = time.perf_counter() - ts
        events += step_events
        if admit_step_s is None and any(
            ev.request_id == longest and ev.token is not None
            for ev in step_events
        ):
            admit_step_s = step_s
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, reference = counters.launches, counters.reference
    toks = {rid: [] for rid, _, _ in reqs}
    reasons = {}
    for ev in events:
        if ev.token is not None:
            toks[ev.request_id].append(ev.token)
        if ev.done:
            reasons[ev.request_id] = ev.reason
    for rid, _, sp in reqs:
        if (reasons.get(rid) != "finished"
                or len(toks[rid]) != sp.max_new_tokens):
            fail(f"{rid}: {reasons.get(rid)} with {len(toks[rid])} tokens")
        if not all(0 <= t < engine.cfg.vocab_size for t in toks[rid]):
            fail(f"{rid}: token out of range")
    return {"toks": toks, "wall": wall, "admit_step_s": admit_step_s,
            "launches": launches, "reference": reference, "sched": sched}


def chunked_workload(vocab: int) -> dict:
    """The chunked phase's prompts, drawn from numpy seed 0: wave A's
    greedy and sampled prompts (one system prompt plus a suffix each), the
    long unrelated prompt, the flood and a prompt never sent before wave
    B."""
    import numpy as np

    rng = np.random.default_rng(0)

    def draw(n):
        return rng.integers(0, vocab, n).tolist()

    system = draw(CHUNKED_SYSTEM)
    return {
        "greedy": [system + draw(n) for n in CHUNKED_SUFFIXES],
        "sampled": [system + draw(n) for n in CHUNKED_SAMPLED_SUFFIXES],
        "long": draw(CHUNKED_LONG),
        "flood": [draw(CHUNKED_SYSTEM) for _ in range(CHUNKED_FLOODS)],
        "fresh": draw(CHUNKED_SYSTEM),
    }


def serve_chunked_run(engine, sched, work: dict, n_new: int) -> dict:
    """Drive wave A, the flood and wave B through ``sched`` and hold the
    prefix cache's bytes: every pool block is copied to the host, keyed by
    its digest, after the first prefill, after wave A and after the flood;
    a copy taken twice must not change, the rows each wave-B admission
    seeded must equal the copies of their digests, and so must every
    copied block back in the pool after wave B. Tier budgets are checked
    after every step. The K/V rows of each wave-B request's prompt are
    kept (``kv_rows``). Returns what the phase prints and checks."""
    import numpy as np
    import torch

    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams

    toks, reasons, t_submit, t_first, prompts = {}, {}, {}, {}, {}
    long_steps = []  # wall seconds of the steps while "long" prefills
    long_task = []

    def submit(rid, prompt, sp=None):
        sched.submit(prompt, sp or SamplingParams(max_new_tokens=n_new),
                     request_id=rid)
        t_submit[rid] = time.perf_counter()
        toks[rid], prompts[rid] = [], prompt

    def prefilling():
        return {t.request_id: t for t in engine._prefills.values()}

    def step():
        before = prefilling()
        ts = time.perf_counter()
        events = sched.step()
        te = time.perf_counter()
        for ev in events:
            if ev.token is not None:
                toks[ev.request_id].append(ev.token)
                t_first.setdefault(ev.request_id, te)
            if ev.done:
                reasons[ev.request_id] = ev.reason
        after = prefilling()
        if "long" in after and not long_task:
            long_task.append(after["long"])
        if "long" in before or "long" in after:
            long_steps.append(te - ts)
        for tier, row in engine.prefix_tier_stats().items():
            if row["bytes"] > row["budget_bytes"]:
                fail(f"the {tier} tier holds {row['bytes']} bytes over its "
                     f"budget of {row['budget_bytes']}")

    def run(until=None):
        while sched.has_work() and not (until and until()):
            step()

    saved = {}  # digest -> (k, v) on the host

    def snapshot(when):
        n_new_copies = 0
        for d, idx in engine._pool_map.items():
            blk = tuple(t[:, idx].to("cpu", copy=True)
                        for t in (engine._pool_k, engine._pool_v))
            if d in saved:
                if not all(torch.equal(a, b) for a, b in zip(saved[d], blk)):
                    fail(f"pool block {d.hex()} changed between copies "
                         f"({when})")
            else:
                saved[d] = blk
                n_new_copies += 1
        print(f"[serve-chunked] {when}: pool holds "
              f"{len(engine._pool_map)} blocks, {n_new_copies} copied")

    greedy, sampled = work["greedy"], work["sampled"]
    # Wave A. The first request prefills the system prompt alone, so the
    # others find it in the pool. The long prompt arrives while it
    # decodes, ahead of the rest, and is prefilled in chunks between folds.
    submit("a0", greedy[0])
    run(until=lambda: "a0" in t_first)
    snapshot("after the first prefill")
    submit("long", work["long"])
    for i, p in enumerate(greedy[1:], 1):
        submit(f"a{i}", p)
    for i, p in enumerate(sampled):
        submit(f"s{i}", p, SamplingParams(
            max_new_tokens=n_new, temperature=0.8, top_k=50, top_p=0.9,
            seed=100 + i))
    run()
    snapshot("after wave A")
    for i, p in enumerate(work["flood"]):
        submit(f"f{i}", p)
    run()
    snapshot("after the flood")

    # Wave B, one request at a time, each into the lowest free slot.
    bs = engine.prefix_block
    wave_b = [(f"b{i}", p) for i, p in enumerate(greedy)]
    wave_b += [("bf", work["flood"][0]),
               ("bn", work["fresh"])]
    sources, seeded_rows, kv_rows = {}, 0, {}
    for rid, p in wave_b:
        slot = engine.free_slots()[0]
        c0, hit0 = engine.prefix_tier_counters(), engine.prefix_hit_tokens
        submit(rid, p)
        run()
        c1 = engine.prefix_tier_counters()
        src = {
            f"{tier}_{kind}": c1[tier][kind] - c0[tier][kind]
            for tier, kind in (("device", "hits"), ("host", "hits"),
                               ("host", "promotions"), ("disk", "hits"),
                               ("disk", "promotions"))
        }
        src["seeded_blocks"] = (engine.prefix_hit_tokens - hit0) // bs
        src["prompt_blocks"] = len(p) // bs
        sources[rid] = src
        print(f"[serve-chunked] wave B {rid} ({len(p)} tokens) into slot "
              f"{slot}: {json.dumps(src)}")
        kv_rows[rid] = tuple(t[:, slot, :len(p)].clone()
                             for t in (engine._k, engine._v))
        digests = engine._block_digests(np.asarray(p))
        for j in range(src["seeded_blocks"]):
            copy = saved.get(digests[j])
            if copy is None:
                continue
            rows = slice(j * bs, (j + 1) * bs)
            if not (torch.equal(engine._k[:, slot, rows].cpu(), copy[0])
                    and torch.equal(engine._v[:, slot, rows].cpu(), copy[1])):
                fail(f"{rid}: seeded rows of block {j} differ from the copy "
                     f"of digest {digests[j].hex()}")
            seeded_rows += bs
    pool_checked = 0
    for d, idx in engine._pool_map.items():
        if d not in saved:
            continue
        k, v = saved[d]
        if not (torch.equal(engine._pool_k[:, idx].cpu(), k)
                and torch.equal(engine._pool_v[:, idx].cpu(), v)):
            fail(f"pool block {d.hex()} differs from its copy after wave B")
        pool_checked += 1
    for name in ("_k", "_v", "_pool_k", "_pool_v"):
        if not torch.isfinite(getattr(engine, name)).all():
            fail(f"non-finite values in engine.{name}")
    return {
        "toks": toks, "reasons": reasons, "prompts": prompts,
        "t_submit": t_submit, "t_first": t_first, "sources": sources,
        "long_steps": long_steps,
        "long_chunks": long_task[0].chunks if long_task else 0,
        "saved_blocks": len(saved), "checked_pool_blocks": pool_checked,
        "checked_seeded_rows": seeded_rows, "kv_rows": kv_rows,
        "wave_b": wave_b,
    }


def cold_ttfts(params, cfg, requests) -> dict:
    """TTFT of each (request id, prompt) sent alone into an idle chunked
    engine without the prefix cache, as wave B sends them into the cached
    one and timed as it times them (to the end of the step that yields the
    first token, whose fold then runs too): what the cache saves, at the
    same load. A first request warms the engine up."""
    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams, Scheduler

    kw = {k: v for k, v in CHUNKED_ENGINE.items()
          if not k.startswith("prefix_")}
    sched = Scheduler(new_engine(params, cfg, device="cuda", **kw),
                      **CHUNKED_SCHED)
    out = {}
    for rid, prompt in [("warm-up", requests[-1][1])] + list(requests):
        sched.submit(prompt, SamplingParams(max_new_tokens=SERVE_NEW),
                     request_id=rid)
        t0 = time.perf_counter()
        while sched.has_work():
            if any(ev.token is not None for ev in sched.step()):
                out.setdefault(rid, time.perf_counter() - t0)
    del out["warm-up"]
    return out


def phase_serve_chunked(mono_step_s: float) -> int:
    """Chunked prefill and the tiered prefix cache at GPT-2-small width
    (see ``serve_chunked_run``); returns the flash launches of its traffic,
    which must be 0: the chunk path runs the reference op order."""
    import dataclasses
    import shutil

    import torch

    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init_gpt_params(
        torch.Generator(device="cuda").manual_seed(0), cfg
    )
    disk = os.path.join(HERE, "build", "smoke_prefix_disk")
    shutil.rmtree(disk, ignore_errors=True)
    engine = new_engine(params, cfg, device="cuda", prefix_disk_dir=disk,
                          **CHUNKED_ENGINE)
    sched = Scheduler(engine, **CHUNKED_SCHED)
    work = chunked_workload(cfg.vocab_size)
    counters.reset()
    t0 = time.perf_counter()
    res = serve_chunked_run(engine, sched, work, SERVE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, ref_calls = counters.launches, counters.reference
    shutil.rmtree(disk, ignore_errors=True)

    for rid, got in res["toks"].items():
        if res["reasons"].get(rid) != "finished" or len(got) != SERVE_NEW:
            fail(f"{rid}: {res['reasons'].get(rid)} with {len(got)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in got):
            fail(f"{rid}: token out of range")
    print(f"[serve-chunked] {len(res['toks'])} requests, flash launches "
          f"{launches}, reference-path calls {ref_calls}, wall {wall:.3f} s")
    if launches or ref_calls:
        fail("the chunked path called the flash wrapper")
    snap = sched.metrics.snapshot()
    tiers = snap.get("prefix_tiers", {})
    if not snap.get("prefix_hit_rate", 0.0) > 0.0:
        fail(f"prefix hit rate {snap.get('prefix_hit_rate')}")
    for tier, kind in (("device", "hits"), ("host", "promotions"),
                       ("disk", "promotions")):
        if not tiers.get(tier, {}).get(kind, 0) > 0:
            fail(f"no {tier} {kind} in the run: {tiers}")
    bn = res["sources"]["bn"]
    if any(bn[f"{t}_hits"] for t in ("device", "host", "disk")):
        fail(f"the prompt never sent hit a tier: {bn}")
    if not (res["checked_pool_blocks"] and res["checked_seeded_rows"]):
        fail("the byte checks compared nothing")
    print(f"[serve-chunked] bytes: {res['saved_blocks']} blocks copied, "
          f"{res['checked_pool_blocks']} back in the pool and "
          f"{res['checked_seeded_rows']} seeded rows equal to their copies")

    # The solo run below prefills through gpt_prefill_chunk too, so it
    # shows only that chunking and seeding change nothing. Hold the rows
    # the engine computed against a prefill that runs none of the chunk's
    # code: flash attention (K1) over the whole prompt.
    kv_err = {}
    with torch.no_grad():
        for rid, prompt in res["wave_b"]:
            _, fk, fv = gpt.gpt_prefill(
                engine.params, cfg, torch.tensor([prompt], device="cuda")
            )
            k, v = res["kv_rows"][rid]
            kv_err[rid] = max(kv_row_err(k, fk[:, 0]), kv_row_err(v, fv[:, 0]))
    print(f"[serve-chunked] wave-B K/V rows vs the flash prefill, largest "
          f"relative row error (bar {KV_ROW_TOL}): {json.dumps(kv_err)}")
    for rid, err in kv_err.items():
        if not err <= KV_ROW_TOL:
            fail(f"{rid}: K/V rows differ from the flash prefill by {err}")

    # Greedy requests against the port's solo gpt_generate under the
    # reference attention (the chunk's op order); the flash solo is only
    # reported.
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    solos = {}
    near_ties = flash_diffs = flash_reqs = 0
    greedy = [rid for rid in res["toks"] if not rid.startswith("s")]
    for rid in greedy:
        prompt = res["prompts"][rid]
        key = tuple(prompt)
        if key not in solos:
            solos[key] = [
                gpt.gpt_generate(params, c, [prompt], SERVE_NEW,
                                 device="cuda")[0, len(prompt):].tolist()
                for c in (ref_cfg, cfg)
            ]
        solo, flash = solos[key]
        got = res["toks"][rid]
        diff = sum(a != b for a, b in zip(got, flash))
        flash_diffs += diff
        flash_reqs += diff > 0
        if got == solo:
            continue
        j = next(j for j, (a, b) in enumerate(zip(got, solo)) if a != b)
        margin = greedy_margin(params, ref_cfg, prompt + solo[:j])
        print(f"[serve-chunked] {rid}: engine and solo differ first at token "
              f"{j}, solo top-2 margin {margin}")
        if margin >= MARGIN:
            fail(f"{rid}: greedy mismatch at token {j} with margin {margin}")
        near_ties += 1
    print(f"[serve-chunked] greedy vs solo gpt_generate (reference "
          f"attention): {len(greedy)} requests, mismatches at near-ties "
          f"(margin < {MARGIN}): {near_ties}; vs the flash solo: "
          f"{flash_diffs} tokens differ in {flash_reqs} requests (reported)")

    def ttft(rid):
        return res["t_first"][rid] - res["t_submit"][rid]

    twins = {f"b{i}": f"a{i}" for i in range(len(CHUNKED_SUFFIXES))}
    twins["bf"] = "f0"
    cold = cold_ttfts(params, cfg, res["wave_b"])
    chunked = {
        key: snap.get(key) for key in (
            "ttft_p50_s", "ttft_max_s", "ttft_prefill_p50_s",
            "ttft_queue_p50_s", "prefill_chunks_per_admit", "prefix_hit_rate",
        )
    }
    chunked.update({
        "tiers": engine.prefix_tier_stats(),
        "refill_s": engine.refill_s,
        "wave_b_ttft_s": {b: {"wave_b": ttft(b), "cold": cold[b],
                              "wave_a_twin": ttft(a)}
                          for b, a in twins.items()},
        "kv_vs_flash_max_row_err": max(kv_err.values()),
        "never_sent_ttft_s": ttft("bn"),
        "flash_solo_token_diffs": flash_diffs,
        "near_tie_mismatches": near_ties,
        "wall_s": wall,
    })
    print(f"[serve-chunked] {json.dumps(chunked)} on {card_line()}")
    long_max = max(res["long_steps"])
    print(f"[serve-chunked] the {CHUNKED_LONG}-token prompt prefilled in "
          f"{res['long_chunks']} chunks over {len(res['long_steps'])} steps; "
          f"longest step meanwhile {long_max} s; its monolithic admission "
          f"step in the serve phase {mono_step_s} s; on {card_line()}")
    if res["long_chunks"] != -(-CHUNKED_LONG // CHUNKED_ENGINE["prefill_chunk"]):
        fail(f"the long prompt took {res['long_chunks']} chunks")
    return launches


def serve_traffic(engine, sched, reqs, lead: bool = False, later=(),
                  after: int = 0) -> dict:
    """Drive ``reqs`` ((request id, prompt, SamplingParams)) through
    ``sched`` until idle; with ``lead`` the first request goes alone until
    its first token, so its prompt is cached before the rest arrive; the
    ``later`` requests are sent ``after`` steps after the rest. Fails
    unless every request finishes with its token count. Returns the tokens
    of each request, the largest number of requests resident at once and,
    on a paged engine, the page stats at that step, and each step's host
    seconds beside whether a ``later`` prompt was prefilling in it (it was
    parked after the step, or the step gave its first token)."""
    toks = {rid: [] for rid, _, _ in list(reqs) + list(later)}
    late = {rid for rid, _, _ in later}
    reasons = {}
    peak = {"resident": 0, "kv_pages": None}
    steps = []

    def step():
        t0 = time.perf_counter()
        events = sched.step()
        dt = time.perf_counter() - t0
        first = False
        for ev in events:
            if ev.token is not None:
                first |= ev.request_id in late and not toks[ev.request_id]
                toks[ev.request_id].append(ev.token)
            if ev.done:
                reasons[ev.request_id] = ev.reason
        steps.append((dt, first or any(
            t.request_id in late for t in engine._prefills.values())))
        if engine.num_active > peak["resident"]:
            peak["resident"] = engine.num_active
            if engine.paged:
                peak["kv_pages"] = engine.kv_page_stats()

    rest = reqs
    if lead:
        rid, prompt, sp = reqs[0]
        sched.submit(prompt, sp, request_id=rid)
        while not toks[rid]:
            step()
        rest = reqs[1:]
    for rid, prompt, sp in rest:
        sched.submit(prompt, sp, request_id=rid)
    if later:
        for _ in range(after):
            step()
        for rid, prompt, sp in later:
            sched.submit(prompt, sp, request_id=rid)
    while sched.has_work():
        step()
    for rid, _, sp in list(reqs) + list(later):
        got = toks[rid]
        if reasons.get(rid) != "finished" or len(got) != sp.max_new_tokens:
            fail(f"{rid}: {reasons.get(rid)} with {len(got)} tokens")
        if not all(0 <= t < engine.cfg.vocab_size for t in got):
            fail(f"{rid}: token out of range")
    return {"toks": toks, "peak": peak, "steps": steps}


def time_folds(engine) -> list:
    """Record (seconds, tokens emitted) of every fold ``engine.step`` runs
    from now on (a step with no decoding slot runs none). Each fold ends in
    its token-block read, a device sync, so the host clock times it."""
    folds, step = [], engine.step

    def timed():
        if not any(s is not None for s in engine._slots):
            return step()
        t0 = time.perf_counter()
        out = step()
        folds.append((time.perf_counter() - t0, len(out)))
        return out

    engine.step = timed
    return folds


def fold_summary(folds) -> dict:
    """Median ms per fold and mean tokens per fold."""
    import statistics

    return {"ms_per_fold": 1e3 * statistics.median(t for t, _ in folds),
            "tokens_per_fold": sum(n for _, n in folds) / len(folds),
            "folds": len(folds)}


def decode_fold_ms(engine, prompts, n_new: int) -> float:
    """Median host ms of a fold with every slot decoding: one short prompt
    per slot, prefilled, one fold to warm up, then the folds timed until
    the slots drain."""
    import statistics

    engine.admit_many([dict(prompt=p, request_id=f"d{i}", max_new_tokens=n_new)
                       for i, p in enumerate(prompts)])
    while engine.num_prefilling:
        engine.prefill_step(engine.num_slots)
    engine.step()
    times = []
    while engine.num_active:
        t0 = time.perf_counter()
        engine.step()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def compare_greedy(tag, reqs, got, want, params, cfg) -> int:
    """Greedy requests of ``got`` against ``want``, token for token; a
    difference is allowed only where ``want``'s top-2 margin under ``cfg``
    is below MARGIN. Returns how many requests differ."""
    near_ties = 0
    for rid, prompt, sp in reqs:
        a, b = got[rid], want[rid]
        if sp.temperature > 0 or a == b:
            continue
        j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        margin = greedy_margin(params, cfg, prompt + b[:j])
        print(f"[{tag}] {rid}: tokens differ first at {j}, top-2 margin "
              f"{margin}")
        if margin >= MARGIN:
            fail(f"{tag} {rid}: greedy mismatch at token {j} with margin "
                 f"{margin}")
        near_ties += 1
    return near_ties


def paged_workload(vocab: int) -> list:
    """The serve-paged phase's requests, drawn from numpy seed 0, in the
    order they are sent: aliasing (a*) and unrelated (u*) requests in turn,
    a0 first."""
    import numpy as np

    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams

    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, PAGED_SYSTEM).tolist()
    alias = [system + rng.integers(0, vocab, int(n)).tolist()
             for n in rng.integers(16, 65, 12)]
    other = [rng.integers(0, vocab, int(n)).tolist()
             for n in rng.integers(64, 385, 12)]
    news = rng.integers(32, 65, 24)
    reqs = []
    for i in range(12):
        for j, (rid, prompt) in enumerate(((f"a{i}", alias[i]),
                                           (f"u{i}", other[i]))):
            sp = SamplingParams(max_new_tokens=int(news[2 * i + j]))
            if rid in PAGED_SAMPLED:
                sp = SamplingParams(max_new_tokens=sp.max_new_tokens,
                                    temperature=0.8, top_k=50, top_p=0.9,
                                    seed=i)
            reqs.append((rid, prompt, sp))
    return reqs


def serve_paged_run(params, cfg, device) -> dict:
    """The serve-paged traffic through a paged engine and through a dense
    chunked engine of as many slots; the page checks; and the ms of a fold
    with every slot decoding in each. Returns what the phase prints."""
    import dataclasses

    import numpy as np
    import torch

    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    reqs = paged_workload(cfg.vocab_size)
    engine = new_engine(params, cfg, device=device, **PAGED_ENGINE)
    need = sum(engine.pages_for(len(p), sp.max_new_tokens) for _, p, sp in reqs)
    if need <= PAGED_ENGINE["kv_pages"] - 1:
        fail(f"the traffic needs {need} pages, no more than the pool holds")
    sched = Scheduler(engine, **PAGED_SCHED)
    counters.reset()
    t0 = time.perf_counter()
    res = serve_traffic(engine, sched, reqs, lead=True)
    wall = time.perf_counter() - t0
    if counters.launches or counters.reference:
        fail("the paged path called the flash wrapper")
    for i, m in enumerate(engine._pool_meta):
        if m is not None and m.refs:
            fail(f"page {i} still has {m.refs} references at idle")
    idle = engine.kv_page_stats()
    if idle["aliased"] or idle["allocs"] - idle["frees"] != idle["resident"]:
        fail(f"the page ledger does not balance at idle: {idle}")
    if not (res["peak"]["resident"] > 4 and sched.kv_backpressure_steps > 0
            and engine.page_alias_hits > 0):
        fail(f"largest residency {res['peak']['resident']}, backpressure "
             f"steps {sched.kv_backpressure_steps}, alias hits "
             f"{engine.page_alias_hits}: want > 4, > 0 and > 0")
    if not torch.isfinite(engine._pool_k).all() or not torch.isfinite(
            engine._pool_v).all():
        fail("non-finite values in the page pool")
    dense_kw = {k: v for k, v in PAGED_ENGINE.items() if not k.startswith("kv_")}
    dense = new_engine(params, cfg, device=device, **dense_kw)
    dres = serve_traffic(dense, Scheduler(dense, **PAGED_SCHED), reqs,
                         lead=True)
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    near_ties = compare_greedy("serve-paged", reqs, res["toks"], dres["toks"],
                               params, ref_cfg)
    rng = np.random.default_rng(1)
    short = [rng.integers(0, cfg.vocab_size, 16).tolist()
             for _ in range(PAGED_ENGINE["num_slots"])]
    n_new = 6 * PAGED_ENGINE["decode_fold"] + 1
    snap = sched.metrics.snapshot()
    return {
        "requests": len(reqs), "pages_needed": need,
        "max_resident": res["peak"]["resident"],
        "kv_pages_at_max_residency": res["peak"]["kv_pages"],
        "kv_pages_idle": idle,
        "backpressure_steps": sched.kv_backpressure_steps,
        "alias_hits": engine.page_alias_hits,
        "ttft_p50_s": snap["ttft_p50_s"], "ttft_max_s": snap["ttft_max_s"],
        "near_tie_mismatches_vs_dense": near_ties,
        "fold_ms_paged": decode_fold_ms(engine, short, n_new),
        "fold_ms_dense": decode_fold_ms(dense, short, n_new),
        "wall_s": wall,
    }


def phase_serve_paged() -> int:
    """Paged KV at GPT-2-small width through Scheduler -> DecodeEngine (see
    ``serve_paged_run``); returns the flash launches of its traffic: 0,
    the chunked path runs none."""
    import torch

    from ray_lightning_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init_gpt_params(
        torch.Generator(device="cuda").manual_seed(0), cfg
    )
    out = serve_paged_run(params, cfg, "cuda")
    print(f"[serve-paged] {json.dumps(out)} on {card_line()}")
    return 0


def spec_workload(vocab: int) -> list:
    """The serve-spec phase's requests, drawn from numpy seed 0: 8 greedy
    prompts of 96-256 tokens, each a span of 8-32 tokens tiled, so the
    n-gram drafter finds its continuations; 2 sampled ones alike."""
    import numpy as np

    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(10):
        span = rng.integers(0, vocab, int(rng.integers(8, 33))).tolist()
        n = int(rng.integers(96, 257))
        prompt = (span * (n // len(span) + 1))[:n]
        if i < 8:
            reqs.append((f"g{i}", prompt, SamplingParams(max_new_tokens=SPEC_NEW)))
        else:
            reqs.append((f"s{i}", prompt, SamplingParams(
                max_new_tokens=SPEC_NEW, temperature=0.8, top_k=50, top_p=0.9,
                seed=i)))
    return reqs


def draft_params_of(params, n_layer: int) -> dict:
    """A truncated self-draft: the main model's embeddings, final norm and
    first ``n_layer`` blocks."""
    draft = {k: v for k, v in params.items() if k != "blocks"}
    draft["blocks"] = {k: v[:n_layer] for k, v in params["blocks"].items()}
    return draft


def serve_spec_run(params, cfg, device) -> dict:
    """The serve-spec traffic: (a) the paged engine with spec="ngram" and
    with spec="off", (b) a dense monolithic engine with spec="model" and
    with spec="off". Greedy tokens must be equal except at near-ties,
    sampled ones equal; the n-gram drafter must have accepted tokens; the
    flash launches of (b)'s spec run (admissions and draft prefills) are
    counted. Returns what the phase prints and the launch count."""
    import dataclasses

    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    reqs = spec_workload(cfg.vocab_size)
    dcfg = dataclasses.replace(cfg, n_layer=SPEC_DRAFT_LAYERS)
    draft = draft_params_of(params, SPEC_DRAFT_LAYERS)
    setups = {
        ("ngram", "paged"): dict(PAGED_ENGINE, decode_fold=SPEC_FOLD,
                                 spec="ngram", spec_depth=SPEC_DEPTH),
        ("off", "paged"): dict(PAGED_ENGINE, decode_fold=SPEC_FOLD),
        ("model", "dense"): dict(SPEC_MODEL_ENGINE, spec="model",
                                 spec_depth=SPEC_DEPTH, spec_params=draft,
                                 spec_config=dcfg, spec_window=SPEC_WINDOW),
        ("off", "dense"): dict(SPEC_MODEL_ENGINE),
    }
    runs = {}
    for key, kw in setups.items():
        engine = new_engine(params, cfg, device=device, **kw)
        sched = Scheduler(engine, **SPEC_SCHED)
        folds = time_folds(engine)
        counters.reset()
        t0 = time.perf_counter()
        res = serve_traffic(engine, sched, reqs)
        runs[key] = dict(
            res, engine=engine, folds=folds, wall=time.perf_counter() - t0,
            launches=counters.launches, reference=counters.reference,
            admitted=sched.metrics.admitted, snap=sched.metrics.snapshot(),
        )
    out = {}
    for spec, kind in (("ngram", "paged"), ("model", "dense")):
        on, off = runs[(spec, kind)], runs[("off", kind)]
        tag = f"serve-spec {spec}"
        margin_cfg = (dataclasses.replace(cfg, attn_impl="reference")
                      if kind == "paged" else cfg)
        near = compare_greedy(tag, reqs, on["toks"], off["toks"], params,
                              margin_cfg)
        sampled_diff = sum(
            a != b
            for rid, _, sp in reqs if sp.temperature > 0
            for a, b in zip(on["toks"][rid], off["toks"][rid])
        )
        print(f"[{tag}] sampled tokens that differ from spec=\"off\": "
              f"{sampled_diff}")
        if sampled_diff:
            fail(f"{tag}: {sampled_diff} sampled tokens differ from "
                 "spec=\"off\"")
        out[spec] = {
            "engine": kind,
            "spec_stats": on["engine"].spec_stats(),
            "snapshot_accept_rate": on["snap"].get("spec_accept_rate"),
            "fold": fold_summary(on["folds"]),
            "fold_spec_off": fold_summary(off["folds"]),
            "near_tie_mismatches": near,
            "wall_s": on["wall"], "wall_s_spec_off": off["wall"],
        }
    ngram = runs[("ngram", "paged")]
    if ngram["launches"] or ngram["reference"]:
        fail("the paged n-gram path called the flash wrapper")
    if not ngram["engine"].spec_accepted_tokens > 0:
        fail("the n-gram drafter had no token accepted")
    model = runs[("model", "dense")]
    verifies = len(model["folds"]) * SPEC_FOLD
    expect = cfg.n_layer * model["admitted"] + SPEC_DRAFT_LAYERS * verifies
    print(f"[serve-spec model] flash launches {model['launches']}, expected "
          f"{expect}: {cfg.n_layer} layers x {model['admitted']} admissions "
          f"+ {SPEC_DRAFT_LAYERS} draft layers x {verifies} draft window "
          f"prefills; reference-path calls {model['reference']}")
    if model["launches"] != expect or model["reference"]:
        fail(f"flash launches {model['launches']} != {expect}, or reference "
             f"calls {model['reference']}")
    out["model"]["draft_prefill_launches"] = SPEC_DRAFT_LAYERS * verifies
    return {"runs": out, "launches": model["launches"], "draft": draft,
            "draft_cfg": dcfg}


def check_k1_prefill(params, cfg, B: int, S: int, tag: str) -> dict:
    """K1 at a prefill of B prompts of S tokens (random, from a seeded
    generator) under ``params``: the first layer's q/k/v (strided views of
    the fused projection). Held against ``flash_attention_plain``, then
    timed beside it, SDPA and its bound; ``tag`` names the call site in
    what it prints."""
    import torch
    import torch.nn.functional as F

    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.ops.flash_attention import (
        _flash_fwd_cuda,
        flash_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda")
    cdt = gpt.compute_dtype(cfg)
    lp = gpt._layer(params["blocks"], 0)
    with torch.no_grad():
        h = (params["wte"][toks] + params["wpe"][:S]).to(cdt)
        a = gpt._make_norm(cfg)(h, lp["ln1_g"], lp["ln1_b"])
        q, k, v = gpt._project_qkv(a, lp, cfg, cdt)
    scale = cfg.head_dim ** -0.5
    out, lse = _flash_fwd_cuda(q, k, v, True, scale, 0, 0)
    ref, ref_lse = flash_attention_plain(q, k, v, True, scale)
    torch.cuda.synchronize()
    atol, rtol = TOL["bfloat16"]
    err = (out.float() - ref.float()).abs()
    lse_err = float((lse - ref_lse).abs().max())
    if not (bool((err <= atol + rtol * ref.float().abs()).all())
            and lse_err <= LSE_TOL):
        fail(f"flash_fwd disagrees with its plain version at {tag}: max "
             f"abs err {float(err.max())}, lse {lse_err}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    with torch.no_grad():
        row = {
            "shape": list(q.shape),
            "max_abs_err": float(err.max()),
            "lse_err": lse_err,
            "ms": cuda_ms(lambda: _flash_fwd_cuda(q, k, v, True, scale, 0, 0)),
            "plain_ms": cuda_ms(
                lambda: flash_attention_plain(q, k, v, True, scale)),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True)),
        }
    row["bound_ms"], row["bound_by"], flops = flash_bound(q, 0, 0, True)
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
    print(f"[{tag}] flash_fwd, bf16 causal, strided q/k/v {q.stride()}: "
          f"{json.dumps(row)} tol=({atol}+{rtol}*|ref|, lse {LSE_TOL})")
    return row


def phase_serve_spec():
    """Speculative decoding at GPT-2-small width (see ``serve_spec_run``);
    returns K1's launches on the spec="model" path and its draft-prefill
    row: K1 at the draft's window prefill (B = the engine's slots, S =
    SPEC_WINDOW; ``check_k1_prefill``)."""
    import torch

    from ray_lightning_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init_gpt_params(
        torch.Generator(device="cuda").manual_seed(0), cfg
    )
    res = serve_spec_run(params, cfg, "cuda")
    print(f"[serve-spec] {json.dumps(res['runs'])} on {card_line()}")
    row = check_k1_prefill(res["draft"], res["draft_cfg"],
                           SPEC_MODEL_ENGINE["num_slots"], SPEC_WINDOW,
                           "serve-spec model draft window prefill")
    return res["launches"], row


def fused_wave2(vocab: int) -> list:
    """The serve-fused phase's second wave, drawn from numpy seed 3: 4
    unrelated prompts of FUSED_WAVE2 tokens, SERVE_NEW new tokens each, the
    first sampled."""
    import numpy as np

    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams

    rng = np.random.default_rng(3)
    reqs = []
    for i, n in enumerate(rng.integers(*FUSED_WAVE2, 4)):
        sp = SamplingParams(max_new_tokens=SERVE_NEW)
        if i == 0:
            sp = SamplingParams(max_new_tokens=SERVE_NEW, temperature=0.8,
                                top_k=50, top_p=0.9, seed=100)
        reqs.append((f"w{i}", rng.integers(0, vocab, int(n)).tolist(), sp))
    return reqs


def count_syncs(engine, drive) -> tuple:
    """Run ``drive()`` with each of ``engine``'s dispatches watched by
    ``torch.cuda.set_sync_debug_mode("warn")``: the synchronizing CUDA
    calls made inside each dispatch (not the one that switching the mode
    on may make), and the innermost three Python frames of each."""
    import traceback
    import warnings

    import torch

    counts, where = [], set()
    dispatch = engine._dispatch

    def watched():
        syncs = []

        def record(message, *args, **kwargs):
            stack = traceback.extract_stack()[:-1]
            if "synchroniz" in str(message) and any(
                    f.name == "_dispatch" for f in stack):
                frames = [f for f in stack
                          if not f.filename.endswith("warnings.py")][-3:]
                syncs.append(" < ".join(
                    f"{os.path.relpath(f.filename, HERE)}:{f.lineno}"
                    for f in reversed(frames)))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fold = dispatch()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(len(syncs))
        where.update(syncs)
        return fold

    engine._dispatch = watched
    try:
        drive()
    finally:
        del engine._dispatch
    return counts, sorted(where)


def drain(engine) -> None:
    """Step ``engine`` until no slot is occupied and no fold is left in
    flight (a pipelined fold queued after the last token was needed is
    harvested, and the quarantine it held flushed)."""
    while engine.num_active or engine._inflight is not None:
        engine.step()
        engine.pop_chunk_events()


def fused_sync_counts(engine, sampled: bool) -> tuple:
    """Stream syncs per dispatch of the fused paged engine: one short prompt
    per slot (numpy seed 5; slot 0's sampled when ``sampled``), their
    chunks piggybacked, then folds until idle."""
    import numpy as np

    rng = np.random.default_rng(5)
    reqs = [dict(prompt=rng.integers(0, engine.cfg.vocab_size, 16).tolist(),
                 request_id=f"y{i}", max_new_tokens=2 * engine.decode_fold + 1,
                 temperature=0.8 if sampled and i == 0 else 0.0, top_k=50,
                 top_p=0.9, seed=i)
            for i in range(engine.num_slots)]

    def drive():
        engine.admit_many(reqs)
        drain(engine)

    return count_syncs(engine, drive)


def fused_compare(tag, reqs, got, want, params, cfg) -> dict:
    """Greedy tokens of ``got`` against ``want`` (a difference allowed only
    at a near-tie under ``cfg``), sampled ones exactly (fails on any)."""
    near = compare_greedy(tag, reqs, got, want, params, cfg)
    sampled_diff = sum(
        a != b
        for rid, _, sp in reqs if sp.temperature > 0
        for a, b in zip(got[rid], want[rid])
    )
    print(f"[{tag}] near-tie greedy mismatches {near}, sampled tokens that "
          f"differ {sampled_diff}")
    if sampled_diff:
        fail(f"{tag}: {sampled_diff} sampled tokens differ")
    return {"near_tie_mismatches": near, "sampled_tokens_differ": sampled_diff}


def ms_per_token(run) -> float:
    """Wall milliseconds per emitted token of a run."""
    return 1e3 * run["wall"] / sum(len(t) for t in run["toks"].values())


def longest_late_step(run):
    """The longest step while a second-wave prompt prefilled, seconds."""
    return max((t for t, late in run["steps"] if late), default=None)


def in_turns(run, kw: dict) -> tuple:
    """``run(engine kwargs)`` with ``kw`` pipelined and not, in turns
    (pipelined, not, not, pipelined), so the two are compared within one
    call whatever warms up along the way. Returns the pipelined runs and
    the unpipelined ones, first run first."""
    nopipe = dict(kw, pipeline=False)
    a1, b1, b2, a2 = run(kw), run(nopipe), run(nopipe), run(kw)
    return [a1, a2], [b1, b2]


def pipeline_times(pipe, nopipe) -> dict:
    """Wall ms per token of the runs in turns, pipelined and not."""
    return {"ms_per_token": [ms_per_token(r) for r in pipe],
            "ms_per_token_nopipe": [ms_per_token(r) for r in nopipe]}


def in_turns_eager(run, kw: dict) -> tuple:
    """``in_turns`` with the private eager dispatch (``_graphs=False``,
    pipelined) in the middle: pipelined, not, eager, eager, not,
    pipelined. Returns the pipelined, unpipelined and eager runs."""
    nopipe, eager = dict(kw, pipeline=False), dict(kw, _graphs=False)
    runs = [run(k) for k in (kw, nopipe, eager, eager, nopipe, kw)]
    return [runs[0], runs[5]], [runs[1], runs[4]], runs[2:4]


def clock_programs(engine) -> list:
    """Wrap each of ``engine``'s dispatch programs in a pair of CUDA events;
    returns the list the pairs are appended to. A replay is one launch, so
    its pair times the graph's device work."""
    import torch

    pairs = []
    for key, prog in list(engine._programs.items()):
        def timed(prog=prog):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            prog()
            b.record()
            pairs.append((a, b))
        engine._programs[key] = timed
    return pairs


def graph_times(pipe, nopipe, eager) -> dict:
    """Wall ms per token of the graph runs and the eager ones, and the
    device's idle share: 1 - (device ms of the dispatch replays) / wall.
    The eager runs launch the same kernels, so their idle share uses the
    first pipelined graph run's device ms."""
    dev = pipe[0]["device_ms"]
    return {
        "ms_per_token_eager": [ms_per_token(r) for r in eager],
        "device_ms_dispatches": [r["device_ms"] for r in pipe + nopipe],
        "idle_share": [1 - r["device_ms"] / (1e3 * r["wall"])
                       for r in pipe],
        "idle_share_nopipe": [1 - r["device_ms"] / (1e3 * r["wall"])
                              for r in nopipe],
        "idle_share_eager": [1 - dev / (1e3 * r["wall"]) for r in eager],
        "wall_s_eager": [r["wall"] for r in eager],
    }


def device_ms(pairs) -> float:
    import torch

    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs)


def serve_fused_paged(params, cfg, device) -> dict:
    """(a) The serve-paged traffic plus the long second wave through the
    fused paged engine, pipelined and not in turns, and through the
    serve-paged engine (no piggyback, no ladder, no pipeline): the checks
    of the fused engine, its tokens against the serve-paged engine's, the
    wall per token, the longest step while a second-wave prompt prefills,
    and the stream syncs per dispatch. Returns what the phase prints."""
    import dataclasses

    import torch

    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    wave1, wave2 = paged_workload(cfg.vocab_size), fused_wave2(cfg.vocab_size)

    def run(kw):
        engine = new_engine(params, cfg, device=device, **kw)
        pairs = clock_programs(engine) if kw.get("_graphs", True) else []
        sched = Scheduler(engine, **PAGED_SCHED)
        counters.reset()
        t0 = time.perf_counter()
        res = serve_traffic(engine, sched, wave1, lead=True, later=wave2,
                            after=FUSED_AFTER)
        if device == "cuda":
            torch.cuda.synchronize()
        res.update(engine=engine, wall=time.perf_counter() - t0,
                   snap=sched.metrics.snapshot(), device_ms=device_ms(pairs))
        if counters.launches or counters.reference:
            fail("serve-fused paged: the chunk path called the flash wrapper")
        drain(engine)
        return res

    pipe, nopipe, eager = in_turns_eager(run, FUSED_PAGED_ENGINE)
    paged = run(PAGED_ENGINE)
    reqs = wave1 + wave2
    eng = pipe[0]["engine"]
    if not (eng.piggyback_dispatches > 0
            and eng.piggyback_chunk_rows >= eng.piggyback_dispatches):
        fail(f"piggybacked dispatches {eng.piggyback_dispatches}, rows "
             f"{eng.piggyback_chunk_rows}")
    rungs = [k for k, n in eng.fold_dispatches.items() if n]
    if len(rungs) < 2:
        fail(f"one rung dispatched: {eng.fold_dispatches}")
    for i, m in enumerate(eng._pool_meta):
        if m is not None and m.refs:
            fail(f"page {i} still has {m.refs} references at idle")
    idle = eng.kv_page_stats()
    if (eng._quarantine or idle["aliased"]
            or idle["allocs"] - idle["frees"] != idle["resident"]):
        fail(f"the page ledger does not balance at idle: {idle}, "
             f"quarantine {eng._quarantine}")
    if not (torch.isfinite(eng._pool_k).all()
            and torch.isfinite(eng._pool_v).all()):
        fail("non-finite values in the page pool")
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    out = {
        "vs_serve_paged": fused_compare(
            "serve-fused paged", reqs, pipe[0]["toks"], paged["toks"],
            params, ref_cfg),
        "nopipe_vs_serve_paged": fused_compare(
            "serve-fused paged nopipe", reqs, nopipe[0]["toks"],
            paged["toks"], params, ref_cfg),
        "eager_vs_graphs": fused_compare(
            "serve-fused paged eager", reqs, eager[0]["toks"],
            pipe[0]["toks"], params, ref_cfg),
    }
    out.update(requests=len(reqs), **pipeline_times(pipe, nopipe),
               **graph_times(pipe, nopipe, eager))
    out.update({
        "ms_per_token_serve_paged": ms_per_token(paged),
        "longest_wave2_step_s": [longest_late_step(r) for r in pipe],
        "longest_wave2_step_s_nopipe": [longest_late_step(r) for r in nopipe],
        "longest_wave2_step_s_serve_paged": longest_late_step(paged),
        "ttft_p50_s": [r["snap"]["ttft_p50_s"] for r in pipe],
        "ttft_max_s": [r["snap"]["ttft_max_s"] for r in pipe],
        "ttft_p50_s_nopipe": [r["snap"]["ttft_p50_s"] for r in nopipe],
        "ttft_p50_s_serve_paged": paged["snap"]["ttft_p50_s"],
        "ttft_max_s_serve_paged": paged["snap"]["ttft_max_s"],
        "fold_dispatches": eng.fold_dispatches,
        "fold_dispatches_nopipe": nopipe[0]["engine"].fold_dispatches,
        "piggyback_dispatches": eng.piggyback_dispatches,
        "piggyback_chunk_rows": eng.piggyback_chunk_rows,
        "max_resident": pipe[0]["peak"]["resident"],
        "wall_s": [r["wall"] for r in pipe],
        "wall_s_nopipe": [r["wall"] for r in nopipe],
        "wall_s_serve_paged": paged["wall"],
    })
    greedy, greedy_where = fused_sync_counts(eng, sampled=False)
    sampled, sampled_where = fused_sync_counts(eng, sampled=True)
    print(f"[serve-fused paged] stream syncs per dispatch: greedy {greedy} "
          f"at {greedy_where}; sampled {sampled} at {sampled_where}")
    if max(greedy) != 0 or max(sampled) != 0:
        fail(f"a pipelined dispatch synchronized with the stream: greedy "
             f"{greedy} at {greedy_where}, sampled {sampled} at "
             f"{sampled_where}")
    out.update(syncs_per_dispatch_greedy=greedy,
               syncs_per_dispatch_sampled=sampled)
    return out


def serve_fused_spec(params, cfg, device) -> dict:
    """(b) The serve-spec traffic through the dense fused n-gram engine,
    pipelined and not in turns (tokens compared, wall per token), then a
    cancel that races a verify in flight: a sampled request s and a greedy
    batchmate; after one harvested fold the batchmate is cancelled while
    the next verify is queued and a new request takes its slot. No token
    of the cancelled request may surface after the cancel; the new
    tenant's and s's tokens must equal each served alone."""
    import dataclasses

    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    reqs = spec_workload(cfg.vocab_size)
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")

    def run(kw):
        engine = new_engine(params, cfg, device=device, **kw)
        pairs = clock_programs(engine) if kw.get("_graphs", True) else []
        sched = Scheduler(engine, **SPEC_SCHED)
        counters.reset()
        t0 = time.perf_counter()
        res = serve_traffic(engine, sched, reqs)
        res.update(engine=engine, wall=time.perf_counter() - t0,
                   device_ms=device_ms(pairs))
        if counters.launches or counters.reference:
            fail("serve-fused spec: the chunk path called the flash wrapper")
        return res

    pipe, nopipe, eager = in_turns_eager(run, FUSED_SPEC_ENGINE)
    out = {"pipe_vs_nopipe": fused_compare(
        "serve-fused spec", reqs, pipe[0]["toks"], nopipe[0]["toks"],
        params, ref_cfg),
        "eager_vs_graphs": fused_compare(
        "serve-fused spec eager", reqs, eager[0]["toks"], pipe[0]["toks"],
        params, ref_cfg)}
    eng = pipe[0]["engine"]
    if not (eng.piggyback_dispatches > 0 and eng.spec_accepted_tokens > 0):
        fail(f"serve-fused spec: piggybacked dispatches "
             f"{eng.piggyback_dispatches}, accepted tokens "
             f"{eng.spec_accepted_tokens}")

    s_req = next(r for r in reqs if r[2].temperature > 0)
    cast = [("s", s_req[1], s_req[2]), ("victim", reqs[0][1], reqs[0][2]),
            ("next", reqs[1][1], reqs[1][2])]
    engine = new_engine(params, cfg, device=device, **FUSED_SPEC_ENGINE)
    sched = Scheduler(engine, **SPEC_SCHED)
    toks = {rid: [] for rid, _, _ in cast}
    reasons = {}

    def step():
        for ev in sched.step():
            if ev.token is not None:
                toks[ev.request_id].append(ev.token)
            if ev.done:
                reasons[ev.request_id] = ev.reason

    for rid, prompt, sp in cast[:2]:
        sched.submit(prompt, sp, request_id=rid)
    while len(toks["victim"]) < 2:  # its first token and a harvested fold
        step()
    if engine._inflight is None:
        fail("serve-fused spec: no verify in flight at the cancel")
    slot_v = next(s for s, r in sched._slot_req.items()
                  if r.request_id == "victim")
    at_cancel = len(toks["victim"])
    sched.cancel("victim")
    sched.submit(cast[2][1], cast[2][2], request_id="next")
    step()
    slot_n = next(s for s, r in sched._slot_req.items()
                  if r.request_id == "next")
    while sched.has_work():
        step()
    drain(engine)
    if len(toks["victim"]) != at_cancel or reasons.get("victim") != "cancelled":
        fail(f"serve-fused spec: the cancelled request has "
             f"{len(toks['victim']) - at_cancel} tokens after its cancel, "
             f"terminal {reasons.get('victim')}")
    if slot_n != slot_v:
        fail(f"serve-fused spec: the new request took slot {slot_n}, not the "
             f"cancelled one's {slot_v}")
    alone = {}
    for rid, prompt, sp in (cast[0], cast[2]):
        e = new_engine(params, cfg, device=device,
                         **dict(FUSED_SPEC_ENGINE, pipeline=False))
        alone[rid] = serve_traffic(e, Scheduler(e, **SPEC_SCHED),
                                   [(rid, prompt, sp)])["toks"][rid]
    if toks["s"] != alone["s"]:
        fail("serve-fused spec: the sampled survivor's tokens differ from "
             "its run alone")
    near = compare_greedy("serve-fused spec cancel", [cast[2]], toks, alone,
                          params, ref_cfg)
    out.update(pipeline_times(pipe, nopipe))
    out.update(graph_times(pipe, nopipe, eager))
    out.update({
        "spec_stats": eng.spec_stats(),
        "piggyback_dispatches": eng.piggyback_dispatches,
        "fold_dispatches": eng.fold_dispatches,
        "cancel": {"victim_tokens_at_cancel": at_cancel,
                   "victim_tokens_after": len(toks["victim"]) - at_cancel,
                   "slot": slot_v, "next_near_tie_mismatches": near,
                   "survivor_equal_alone": True},
        "wall_s": [r["wall"] for r in pipe],
        "wall_s_nopipe": [r["wall"] for r in nopipe],
    })
    return out


def serve_fused_mono(params, cfg, serve4: dict) -> dict:
    """(c) The serve phase's engine and traffic with the pipelined dispatch,
    in turns with the unpipelined engine: tokens against the serve phase's,
    K1's launches (12 per admission) counted over the first pipelined run,
    K1 held against its plain version at the longest admission's shape,
    and the wall per token pipelined and not."""
    import numpy as np


    def run(kw):
        engine = new_engine(params, cfg, device="cuda", **kw)
        return serve_run(
            engine, serve_workload(cfg.vocab_size, np.random.default_rng(0)))

    pipe, nopipe = in_turns(run, dict(SERVE_ENGINE, pipeline=True))
    first = pipe[0]
    admissions = first["sched"].metrics.admitted
    print(f"[serve-fused mono] flash launches {first['launches']}, "
          f"{admissions} admissions, reference-path calls "
          f"{first['reference']}")
    if first["launches"] != admissions * cfg.n_layer or first["reference"]:
        fail(f"flash launches {first['launches']} != admissions x layers "
             f"{admissions * cfg.n_layer}, or reference calls "
             f"{first['reference']}")
    reqs = serve_workload(cfg.vocab_size, np.random.default_rng(0))
    cmp = fused_compare("serve-fused mono", reqs, first["toks"],
                        serve4["toks"], params, cfg)
    row = check_k1_prefill(params, cfg, 1, SERVE_LENGTHS[-1],
                           "serve-fused mono admission")
    return {"launches": first["launches"], "admissions": admissions,
            "vs_serve": cmp, **pipeline_times(pipe, nopipe),
            "admit_step_s_longest_prompt": [r["admit_step_s"] for r in pipe],
            "admit_step_s_longest_prompt_nopipe": [
                r["admit_step_s"] for r in nopipe],
            "k1": row, "wall_s": [r["wall"] for r in pipe],
            "wall_s_nopipe": [r["wall"] for r in nopipe]}


#: serve-fused (a) and (b) run GPT-2 small's width at this depth (its
#: embeddings, final norm and first blocks): their gates hold the phase's
#: engines against each other and against solos on the same weights, and
#: the whole script's time asked for a cut (it ran past ~950 s when the
#: serve-mesh phase came). (c) holds phase 4's tokens at full depth.
FUSED_LAYERS = 6


def phase_serve_fused(serve4: dict):
    """Piggybacked chunks, the fold ladder and the pipelined dispatch at
    GPT-2-small width (``serve_fused_paged``, ``serve_fused_spec`` at
    ``FUSED_LAYERS`` blocks, ``serve_fused_mono`` at full depth); returns
    K1's launches on (c), the one sub-phase that launches it."""
    import dataclasses

    import torch

    from ray_lightning_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init_gpt_params(
        torch.Generator(device="cuda").manual_seed(0), cfg
    )
    cut = (draft_params_of(params, FUSED_LAYERS),
           dataclasses.replace(cfg, n_layer=FUSED_LAYERS), "cuda")
    out = {}
    for tag, fn, args in (
        ("paged", serve_fused_paged, cut),
        ("spec", serve_fused_spec, cut),
        ("mono", serve_fused_mono, (params, cfg, serve4)),
    ):
        t0 = time.perf_counter()
        out[tag] = fn(*args)
        out[tag]["graphs"] = check_engines(f"serve-fused {tag}")
        print(f"[serve-fused {tag}] {json.dumps(out[tag])} on {card_line()}")
        print(f"[time] serve-fused {tag}: {time.perf_counter() - t0:.3f} s")
    return out["mono"]["launches"]


#: serve-int8: the resident weight bytes of the int8 engine against phase
#: 4's bf16 engine (blocks in bf16, wte and the head copy in fp32: about
#: 481 MB at GPT-2 small; int8 blocks and wte with their scales and fp32
#: wpe: about 127 MB).
INT8_RESIDENT_MAX = 0.3
#: serve-lifecycle: a delay-only fault plan (each scheduler point fires
#: once, at its third hit) and the observers' ring and journal sizes.
LIFECYCLE_FAULTS = [
    {"point": p, "action": "delay", "seconds": 0.001, "after": 3}
    for p in ("post_admit", "mid_prefill_chunk", "fold_boundary",
              "post_finish_pre_ack")
]


def weight_mib(engine) -> float:
    """Resident MiB of an engine's weights (the draft's included)."""
    from ray_lightning_tpu_torch.utils.quantize import weight_bytes

    n = weight_bytes(engine.params)
    if engine._spec_params is not None:
        n += weight_bytes(engine._spec_params)
    return n / 2**20


def phase_serve_int8(serve4: dict) -> int:
    """Weight-only int8 serving at GPT-2-small width through the entry
    point ``build_engine(int8=True)``: (a) the serve phase's engine and
    traffic on the int8 weights, beside the same engine on
    ``dequantize_params`` of the same tree (greedy and sampled tokens
    bitwise equal) and the solo ``gpt_generate`` on the int8 tree (greedy,
    except at near-ties); (b) the draft-model spec engine, the main model
    and its 6-block self-draft both int8 (``spec_draft_int8``, the draft
    from a checkpoint under ``build/``), against (a)'s tokens (spec
    "off"). Gates: resident weight bytes at most INT8_RESIDENT_MAX of phase
    4's engine, every int8 leaf int8 on the card (no float copy, no
    ``head_c``), 0 stream syncs per greedy and sampled dispatch, K1 12 per
    admission and 6 per verify. Prints resident and graph-pool MiB,
    capture seconds, and ms per fold int8 against bf16 in turns with the
    device's idle share. Returns K1's launches."""
    import dataclasses

    import numpy as np
    import torch

    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.serve.server import build_engine
    from ray_lightning_tpu_torch.utils.quantize import (
        dequantize_params,
        is_quantized,
        quantize_params_int8,
    )
    from ray_lightning_tpu_torch.utils.state_stream import (
        state_stream_to_file,
        to_state_stream,
    )

    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init_gpt_params(
        torch.Generator(device="cuda").manual_seed(0), cfg
    )
    q = quantize_params_int8(params)
    t0 = time.perf_counter()
    engine = build_engine(params=params, model_config=cfg, int8=True,
                          device="cuda", **SERVE_ENGINE)
    build_s = time.perf_counter() - t0
    register_engine(engine)
    ep = engine.params
    if "head_c" in ep or not all(
            is_quantized(ep["blocks"][k]) for k in ("wqkv", "wo", "wi", "wo2")):
        fail("serve-int8: the engine holds a float copy of an int8 leaf")
    for name, node in [("wte", ep["wte"])] + [
            (k, ep["blocks"][k]) for k in ("wqkv", "wo", "wi", "wo2")]:
        ref = q["wte"] if name == "wte" else q["blocks"][name]
        if node["q"].dtype != torch.int8 or not (
                torch.equal(node["q"], ref["q"])
                and torch.equal(node["s"], ref["s"])):
            fail(f"serve-int8: {name} is not the quantizer's int8 node")
    deq = new_engine(dequantize_params(q), cfg, device="cuda", **SERVE_ENGINE)
    bf16 = serve4["sched"].engine
    reqs = serve_workload(cfg.vocab_size, np.random.default_rng(0))
    counters.reset()
    run = serve_run(engine, reqs)
    launches, ref_calls = counters.launches, counters.reference
    admissions = run["sched"].metrics.admitted
    if launches != admissions * cfg.n_layer or ref_calls:
        fail(f"serve-int8: flash launches {launches} != admissions x layers "
             f"{admissions * cfg.n_layer}, or reference calls {ref_calls}")
    run_deq = serve_run(deq, reqs)
    if run["toks"] != run_deq["toks"]:
        bad = [rid for rid in run["toks"]
               if run["toks"][rid] != run_deq["toks"][rid]]
        fail(f"serve-int8: tokens differ from the dequantized engine's: {bad}")
    solo = {}
    for rid, prompt, sp in reqs:
        if sp.temperature == 0:
            solo[rid] = gpt.gpt_generate(
                q, cfg, [prompt], sp.max_new_tokens, device="cuda"
            )[0, len(prompt):].tolist()
        else:
            solo[rid] = run["toks"][rid]
    near = compare_greedy("serve-int8 vs solo", reqs, run["toks"], solo, q,
                          cfg)
    resident = {"int8": weight_mib(engine), "bf16": weight_mib(bf16),
                "dequantized": weight_mib(deq)}
    ratio = resident["int8"] / resident["bf16"]
    print(f"[serve-int8] resident weight MiB {json.dumps(resident)}, int8 / "
          f"bf16 {ratio:.4f}")
    if ratio > INT8_RESIDENT_MAX:
        fail(f"serve-int8: resident weights {ratio:.4f} of the bf16 engine's "
             f"(at most {INT8_RESIDENT_MAX})")
    syncs = {}
    for tag, sampled in (("greedy", False), ("sampled", True)):
        counts, where = fused_sync_counts(engine, sampled)
        syncs[tag] = counts
        if any(counts):
            fail(f"serve-int8 {tag}: stream syncs in a dispatch: {counts} "
                 f"at {where}")

    # (b) The draft-model spec engine, main model and draft int8.
    dcfg = dataclasses.replace(cfg, n_layer=SPEC_DRAFT_LAYERS)
    ckpt = os.path.join(HERE, "build", "smoke_int8_draft.ckpt")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    state_stream_to_file(to_state_stream({
        "params": draft_params_of(params, SPEC_DRAFT_LAYERS),
        "gpt_config": dataclasses.asdict(dcfg)}), ckpt)
    try:
        spec = build_engine(
            params=params, model_config=cfg, int8=True, spec="model",
            spec_depth=SPEC_DEPTH, spec_draft_ckpt=ckpt,
            spec_draft_int8=True, spec_window=SPEC_WINDOW, device="cuda",
            **SPEC_MODEL_ENGINE)
    finally:
        os.remove(ckpt)
    register_engine(spec)
    if not is_quantized(spec._spec_params["blocks"]["wqkv"]):
        fail("serve-int8: the draft is not int8")
    folds = time_folds(spec)
    counters.reset()
    run_spec = serve_run(spec, reqs)
    spec_launches = counters.launches
    verifies = len(folds) * SPEC_FOLD
    expect = (cfg.n_layer * run_spec["sched"].metrics.admitted
              + SPEC_DRAFT_LAYERS * verifies)
    print(f"[serve-int8 spec] flash launches {spec_launches}, expected "
          f"{expect} ({verifies} verifies), reference-path calls "
          f"{counters.reference}")
    if spec_launches != expect or counters.reference:
        fail(f"serve-int8 spec: flash launches {spec_launches} != {expect}")
    spec_cmp = fused_compare("serve-int8 spec vs off", reqs, run_spec["toks"],
                             run["toks"], q, cfg)

    # ms per fold, int8 against bf16, in turns (int8, bf16, bf16, int8).
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 16).tolist()
               for _ in range(engine.num_slots)]
    runs = [decode_alone(e, prompts) for e in (engine, bf16, bf16, engine)]
    dev = {"int8": fold_device_ms(engine, engine.decode_fold),
           "bf16": fold_device_ms(bf16, bf16.decode_fold)}
    int8_ms = [runs[0][0], runs[3][0]]
    bf16_ms = [runs[1][0], runs[2][0]]
    out = {
        "resident_mib": resident,
        "resident_ratio": ratio,
        "graph_pool_mib": {"int8": engine.graph_bytes / 2**20,
                           "dequantized": deq.graph_bytes / 2**20,
                           "bf16": bf16.graph_bytes / 2**20,
                           "spec_int8": spec.graph_bytes / 2**20},
        "capture_s": {"int8": engine.capture_s, "dequantized": deq.capture_s,
                      "bf16": bf16.capture_s, "spec_int8": spec.capture_s},
        "build_engine_s": build_s,
        "ms_per_fold_int8": int8_ms,
        "ms_per_fold_bf16": bf16_ms,
        "device_ms_per_fold": dev,
        "idle_share_int8": [1 - dev["int8"] / t for t in int8_ms],
        "idle_share_bf16": [1 - dev["bf16"] / t for t in bf16_ms],
        "near_tie_mismatches_vs_solo": near,
        "spec_vs_off": spec_cmp,
        "spec_stats": spec.spec_stats(),
        "syncs_per_dispatch": syncs,
        "launches": launches + spec_launches,
        "admissions": admissions,
        "wall_s": run["wall"], "wall_s_spec": run_spec["wall"],
    }
    print(f"[serve-int8] {json.dumps(out)} on {card_line()}")
    return launches + spec_launches


def lifecycle_requests(vocab: int) -> list:
    """Wave A of the serve-chunked phase as requests: the long unrelated
    prompt first (its prefill completes early, so a drain finds its blocks
    cached), then the system prompt's greedy and sampled suffixes."""
    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams

    work = chunked_workload(vocab)
    reqs = [("long", work["long"], SamplingParams(max_new_tokens=SERVE_NEW))]
    reqs += [(f"g{i}", p, SamplingParams(max_new_tokens=SERVE_NEW))
             for i, p in enumerate(work["greedy"])]
    reqs += [(f"s{i}", p, SamplingParams(max_new_tokens=SERVE_NEW,
                                         temperature=0.8, top_k=50,
                                         top_p=0.9, seed=i))
             for i, p in enumerate(work["sampled"])]
    return reqs


def lifecycle_run(params, cfg, reqs, observe: bool, disk: str) -> dict:
    """Wave A through a fresh serve-chunked engine, with every observer on
    (tracer, event log, journal spilling under ``build/``, a registry
    behind ServeMetrics, the phase ledger, the delay-only fault plan) or
    none."""
    from ray_lightning_tpu_torch import obs
    from ray_lightning_tpu_torch.serve.faults import FaultInjector
    from ray_lightning_tpu_torch.serve.metrics import ServeMetrics
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    engine = new_engine(params, cfg, device="cuda", prefix_disk_dir=disk,
                        **CHUNKED_ENGINE)
    kw, extra = {}, {}
    if observe:
        spill = os.path.join(HERE, "build", "smoke_journal")
        shutil.rmtree(spill, ignore_errors=True)
        extra = dict(tracer=obs.RequestTracer(capacity=1 << 16),
                     events=obs.EventLog(capacity=1 << 14),
                     journal=obs.WorkloadJournal(capacity=1 << 14,
                                                 spill_dir=spill),
                     registry=obs.MetricsRegistry())
        extra["faults"] = FaultInjector.parse(LIFECYCLE_FAULTS,
                                              events=extra["events"])
        extra["journal"].set_header(obs.engine_header(engine, **CHUNKED_SCHED))
        kw = dict(tracer=extra["tracer"], events=extra["events"],
                  journal=extra["journal"], faults=extra["faults"],
                  metrics=ServeMetrics(engine.num_slots,
                                       registry=extra["registry"]))
    sched = Scheduler(engine, **CHUNKED_SCHED, **kw)
    sched.phase_ledger = observe
    t0 = time.perf_counter()
    res = serve_traffic(engine, sched, reqs)
    wall = time.perf_counter() - t0
    if observe:
        extra["journal"].close()
    return dict(res, engine=engine, sched=sched, wall=wall, **extra)


def lifecycle_drain(params, cfg, reqs, want: dict) -> dict:
    """A drain armed mid-traffic: wave A through a serve-chunked engine
    until the first system-prompt request has its first token (the system
    prompt's blocks then sit in the pool), then a drain whose budget lets
    the residents with the fewest remaining tokens finish and migrates the
    rest (the policy's estimate at this step's decode rate) and the queue.
    Every finisher must complete its tokens; every migrated request's
    exported blocks go to a second engine through
    ``enqueue_prefix_import``, where the resubmitted request must be
    admitted warm (``prefix_hit_tokens > 0``). A migrated request that
    exported nothing must resubmit cold (``prefix_hit_tokens == 0``): the
    long unrelated prompt can be one, since its 56 blocks, inserted while
    the system prompt's blocks are pinned, may evict their own head into
    the 16-block host tier, which drops it (the JAX engine's insert does
    the same). Both sets' tokens are held against ``want`` (the
    uninterrupted run's) and the greedy ones against the solo
    ``gpt_generate`` under reference attention, except at near-ties;
    sampled ones exactly."""
    import dataclasses

    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    engine = new_engine(params, cfg, device="cuda", **CHUNKED_ENGINE)
    sched = Scheduler(engine, **CHUNKED_SCHED)
    by_rid = {rid: (prompt, sp) for rid, prompt, sp in reqs}
    for rid, prompt, sp in reqs:
        sched.submit(prompt, sp, request_id=rid)
    toks = {rid: [] for rid in by_rid}
    events = []

    def step():
        evs = sched.step()
        events.extend(evs)
        for ev in evs:
            if ev.token is not None:
                toks[ev.request_id].append(ev.token)

    while not toks["g0"]:
        step()
    rate = float(sched.metrics.snapshot()["decode_tokens_per_sec"])
    resident = list(sched._slot_req.values())
    left = sorted(r.sampling.max_new_tokens - len(toks[r.request_id])
                  for r in resident)
    budget = 2.0 * left[0] * len(resident) / rate * (1 + 1e-6)
    export_s = []
    export = engine.export_prefix_blocks

    def timed_export(tokens):
        t = time.perf_counter()
        out = export(tokens)
        export_s.append(time.perf_counter() - t)
        return out

    engine.export_prefix_blocks = timed_export
    sched.request_drain(budget)
    step()
    del engine.export_prefix_blocks
    plan = sched.drain_result(timeout=5.0)
    while sched.has_work():
        step()
    reasons = {ev.request_id: ev.reason for ev in events if ev.done}
    for rid in plan["finish"]:
        if (reasons.get(rid) != "finished"
                or len(toks[rid]) != by_rid[rid][1].max_new_tokens):
            fail(f"serve-lifecycle drain: finisher {rid} ended "
                 f"{reasons.get(rid)} with {len(toks[rid])} tokens")
    migrate = plan["migrate"]
    if not plan["finish"] or not migrate:
        fail(f"serve-lifecycle drain: finish {plan['finish']}, migrate "
             f"{[m['request_id'] for m in migrate]}: both must be non-empty")
    survivor = new_engine(params, cfg, device="cuda", **CHUNKED_ENGINE)
    s2 = Scheduler(survivor, **CHUNKED_SCHED)
    nbytes = sum(len(m["blocks"]) for m in migrate) * engine.prefix_block_nbytes
    t0 = time.perf_counter()
    for m in migrate:
        if m["blocks"]:
            s2.enqueue_prefix_import(m["blocks"])
    s2.step()  # the imports, applied at the top of the step
    import torch

    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    moved = {m["request_id"] for m in migrate}
    cold = {m["request_id"] for m in migrate if not m["blocks"]}
    got = serve_traffic(survivor, s2,
                        [(rid, *by_rid[rid]) for rid, _, _ in reqs
                         if rid in moved])["toks"]
    warm = {r["request_id"]: r["prefix_hit_tokens"]
            for r in s2.metrics.cost_records()}
    for rid in moved:
        if (rid in cold) != (not warm.get(rid)):
            fail(f"serve-lifecycle drain: migrated {rid} "
                 f"({'no' if rid in cold else 'some'} blocks exported) was "
                 f"admitted with {warm.get(rid)} prefix tokens")
    done = {rid: toks[rid] for rid in plan["finish"]}
    done.update(got)
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    mine = [r for r in reqs if r[0] in done]
    vs_run = fused_compare("serve-lifecycle drain vs uninterrupted", mine,
                           done, want, params, ref_cfg)
    solo = {rid: (gpt.gpt_generate(params, ref_cfg, [prompt],
                                   sp.max_new_tokens, device="cuda")
                  [0, len(prompt):].tolist()
                  if sp.temperature == 0 else done[rid])
            for rid, prompt, sp in mine}
    vs_solo = compare_greedy("serve-lifecycle drain vs solo", mine, done,
                             solo, params, ref_cfg)
    return {"finish": plan["finish"], "migrate": sorted(moved),
            "vs_uninterrupted": vs_run, "near_tie_mismatches_vs_solo": vs_solo,
            "cold": sorted(cold),
            "budget_s": budget, "rate_tokens_per_s": rate,
            "blocks": sum(len(m["blocks"]) for m in migrate),
            "export_bytes": nbytes, "export_s": sum(export_s),
            "import_s": import_s,
            "prefix_hit_tokens": warm, "toks": got}


def phase_serve_lifecycle() -> int:
    """The request lifecycle record at GPT-2-small width on the
    serve-chunked engine (wave A's traffic): every observer on (tracer,
    event log, journal spilling under ``build/``, a metrics registry, a
    delay-only fault plan) in turns with none (on, off, off, on). Gates:
    tokens bitwise equal; each finished request's anatomy covers its
    latency exactly; the journal replays exact on a fresh engine built
    from its header; the registry's Prometheus text parses and its
    counters equal the ServeMetrics snapshot; a drain armed mid-traffic
    (``lifecycle_drain``); every compiled_count unchanged; 0 stream syncs
    per dispatch with the observers on. Prints ms per token with the
    observers on and off, journal bytes, and the export/import seconds and
    bytes. Returns K1's launches (none: the chunk path)."""
    import torch

    from ray_lightning_tpu_torch import obs
    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.obs.anatomy import (
        assemble_anatomy,
        render_anatomy,
    )
    from ray_lightning_tpu_torch.obs.journal import (
        build_replay_scheduler,
        load_journal,
        replay_journal,
    )
    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams, Scheduler

    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init_gpt_params(
        torch.Generator(device="cuda").manual_seed(0), cfg
    )
    reqs = lifecycle_requests(cfg.vocab_size)
    disk = os.path.join(HERE, "build", "smoke_lifecycle_disk")
    spill = os.path.join(HERE, "build", "smoke_journal")
    counters.reset()
    try:
        runs = [lifecycle_run(params, cfg, reqs, on, disk)
                for on in (True, False, False, True)]
        on, off = [runs[0], runs[3]], [runs[1], runs[2]]
        for r in runs[1:]:
            if r["toks"] != runs[0]["toks"]:
                fail("serve-lifecycle: tokens differ between the runs with "
                     "and without observers")
        first = runs[0]
        tracer, journal, sched = first["tracer"], first["journal"], first["sched"]
        entries = journal.dump()["entries"]
        dump = dict(tracer.dump(len(reqs)), name="replica0")
        for rid, _, _ in reqs:
            led = assemble_anatomy(rid, [dump], journal=entries)
            if not (led["found"] and led["covered"] and abs(
                    led["observed_s"] - led["accounted_s"]
                    - led["unaccounted_s"]) <= 2e-6):
                fail(f"serve-lifecycle: {rid}'s anatomy does not cover its "
                     f"latency: {render_anatomy(led)}")
        snap = sched.metrics.snapshot()
        parsed = obs.parse_prometheus_text(first["registry"].render())
        life = parsed["rlt_serve_requests_total"]
        emitted = sum(len(t) for t in first["toks"].values())
        counts = {k: life.get(f'{{kind="{k}"}}') for k in
                  ("submitted", "admitted", "finished")}
        if (counts != {k: snap[k] for k in counts}
                or parsed["rlt_serve_tokens_emitted_total"][""] != emitted
                or snap["cost"]["emitted_tokens"] != emitted
                or parsed["rlt_serve_engine_steps_total"][""]
                != snap["steps_recorded"]):
            fail(f"serve-lifecycle: registry {counts}, tokens "
                 f"{parsed['rlt_serve_tokens_emitted_total']} against the "
                 f"snapshot {snap} and {emitted} emitted")
        fired = [r["fired"] for r in first["faults"].describe()]
        journal_bytes = sum(os.path.getsize(os.path.join(spill, n))
                            for n in os.listdir(spill))
        j = load_journal(spill)
        replay_sched = build_replay_scheduler(j["header"], params=params,
                                              device="cuda")
        register_engine(replay_sched.engine)
        t0 = time.perf_counter()
        res = replay_journal(j, scheduler=replay_sched)
        replay_s = time.perf_counter() - t0
        if not res["exact"] or res["compared"] != len(reqs):
            fail(f"serve-lifecycle: the journal's replay is not exact: "
                 f"{res['divergence']}, {res['compared']} compared")
        # 0 stream syncs in a dispatch, every observer on.
        eng = first["engine"]
        small = Scheduler(eng, tracer=tracer, events=first["events"],
                          journal=obs.WorkloadJournal(), **CHUNKED_SCHED)

        def drive():
            for i in range(eng.num_slots):
                small.submit(reqs[1][1][:16 + i], SamplingParams(
                    max_new_tokens=2 * eng.decode_fold + 1,
                    temperature=0.8 if i == 0 else 0.0, top_k=50, seed=i))
            small.run_until_idle()

        sync_counts, where = count_syncs(eng, drive)
        if any(sync_counts):
            fail(f"serve-lifecycle: stream syncs in a dispatch with the "
                 f"observers on: {sync_counts} at {where}")
        drain = lifecycle_drain(params, cfg, reqs, first["toks"])
    finally:
        shutil.rmtree(disk, ignore_errors=True)
        shutil.rmtree(spill, ignore_errors=True)
    tokens = sum(len(t) for t in first["toks"].values())
    out = {
        "ms_per_token_observers": [1e3 * r["wall"] / tokens for r in on],
        "ms_per_token_no_observers": [1e3 * r["wall"] / tokens for r in off],
        "journal_bytes": journal_bytes,
        "journal_entries": len(entries),
        "trace_events": len(tracer),
        "faults_fired": fired,
        "replay": {k: res[k] for k in ("exact", "compared",
                                       "tokens_compared")},
        "replay_s": replay_s,
        "syncs_per_dispatch": sync_counts,
        "drain": {k: v for k, v in drain.items() if k != "toks"},
        "phases": snap.get("phases"),
        "cost": snap.get("cost"),
        "launches": counters.launches,
    }
    print(f"[serve-lifecycle] {json.dumps(out)} on {card_line()}")
    return counters.launches


#: The serve-fleet phase: two replicas on one card (half a card each) behind
#: ServeClient -> Router, (a) with the serve phase's engine, (b) with the
#: serve-chunked engine and its host tier, the fleet KV plane on and one
#: KV object store directory shared by both, written through (the disk
#: tier stays off: every replica gets the same kwargs, so both would write
#: one directory). Replica 1's folds wait FLEET_FOLD_DELAY_S each during
#: the failover wave, so its streams are mid-decode when it is killed.
FLEET_GPUS = 0.5
FLEET_CHUNKED_ENGINE = {k: v for k, v in CHUNKED_ENGINE.items()
                        if k != "prefix_disk_mb"}
FLEET_FOLD_DELAY_S = 0.5
#: (b)'s steered wave: the warm replica's folds wait FLEET_STEER_DELAY_S
#: each and it holds FLEET_STEER_LOAD background requests, so its load
#: weight falls below the other replica's despite the affinity bonus, and
#: FLEET_STEER_SUFFIXES new suffixes of the system prompt (one
#: submit_many, one view of the fleet) go to the other replica with a
#: fetch hint naming the warm one. Each fetch moves the 32 blocks of the
#: system prompt (18.9 MB), so the in-flight budget takes all of them.
FLEET_STEER_DELAY_S = 0.25
FLEET_STEER_LOAD = 24
FLEET_STEER_SUFFIXES = (24, 48, 80, 112)
FLEET_KV = dict(kvfleet_timeout_s=30.0, kvfleet_inflight_mb=256.0)
#: Slack on the card's used memory after the fleets are gone: the driver's
#: own CUDA context loads modules lazily while the phase runs solos.
FLEET_MEM_SLACK_MIB = 256


def card_memory_mib() -> int:
    """Used memory of card 0 as ``nvidia-smi`` reports it (MiB), after the
    driver returns its cached blocks."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True)
    return int(out.stdout.strip().splitlines()[0])


def compute_apps() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def child_pids() -> list:
    """Live children of this process (``/proc``), less multiprocessing's
    resource tracker: the fabric's queues start a spawn-context Manager,
    whose launch starts that tracker, which lives as long as this process
    and ends with it."""
    me, kids = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if (int(fields[1]) == me and fields[0] != "Z"
                and b"multiprocessing.resource_tracker" not in cmd):
            kids.append(int(d))
    return kids


def draw_margin(params, cfg, tokens, sp, j: int, device) -> float:
    """How close the solo run's token ``j`` after ``tokens`` was to coming
    out otherwise: greedy, the top-2 logit margin; sampled, the smallest
    of the top-2 margin of the filtered logits plus the Gumbel noise of
    draw ``j`` (the engine and the solo run draw the same noise), the gap
    between the k-th and (k+1)-th scaled logits at the top-k cut, and the
    gap between p and the nucleus mass on either side of the top-p cut (a
    rounding there changes the support). Random weights give a nearly
    flat distribution, where those cuts often fall between near-equal
    logits."""
    import torch

    from ray_lightning_tpu_torch.models import gpt

    with torch.no_grad():
        h, _, _ = gpt.gpt_prefill(params, cfg,
                                  torch.tensor([tokens], device=device))
        norm = gpt._make_norm(cfg)
        h = norm(h[:, -1:], params["lnf_g"], params["lnf_b"])[:, 0]
        logits = gpt._lm_head(h, gpt._head_weight(params, cfg)).float()
        if sp.temperature <= 0:
            top = torch.topk(logits[0], 2).values
            return float(top[0] - top[1])
        gaps = []
        scaled = torch.sort(logits[0] / sp.temperature, descending=True).values
        k = int(sp.top_k or 0)
        if 0 < k < scaled.numel():
            gaps.append(float(scaled[k - 1] - scaled[k]))
            scaled = scaled[:k]
        if sp.top_p is not None and sp.top_p < 1.0:
            mass = torch.cumsum(torch.softmax(scaled, -1), -1)
            cut = int(torch.searchsorted(mass, torch.tensor(
                [sp.top_p], device=mass.device))[0])
            lo = float(mass[cut - 1]) if cut else 0.0
            gaps.append(min(abs(sp.top_p - lo),
                            abs(float(mass[min(cut, mass.numel() - 1)])
                                - sp.top_p)))
        one = torch.ones(1, device=device)
        lg = gpt.filter_logits_batched(
            logits, one * sp.temperature,
            torch.tensor([int(sp.top_k or 0)], device=device),
            one * (1.0 if sp.top_p is None else sp.top_p))
        u = gpt.draw_uniforms(
            torch.tensor([gpt.seed64(sp.seed)], device=device),
            torch.tensor([j], device=device), lg.shape[-1])
        top = torch.topk((lg - torch.log(-torch.log(u)))[0], 2).values
        gaps.append(float(top[0] - top[1]))
    return min(gaps)


def fleet_compare(tag, reqs, got, params, cfg, device, solos,
                  exact=None) -> int:
    """Every request of ``got`` against the solo ``gpt_generate`` with its
    seed (cached in ``solos``): a token may differ only where the solo
    run's next token was a near-tie (``draw_margin`` below MARGIN). With
    ``exact`` (request id -> the tokens of an engine that shares the
    replicas' arithmetic), sampled requests must equal it bitwise and are
    only reported against the solo: an unaligned prompt's solo prefill
    takes the reference attention where the engine's padded one takes
    K1. Returns how many requests differ from the solo."""
    from ray_lightning_tpu_torch.models import gpt

    near = 0
    for rid, prompt, sp in reqs:
        key = (tuple(prompt), sp.temperature, sp.seed)
        if key not in solos:
            solos[key] = gpt.gpt_generate(
                params, cfg, [prompt], sp.max_new_tokens,
                temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p,
                seed=sp.seed, device=device)[0, len(prompt):].tolist()
        want = solos[key]
        gated = exact is None or sp.temperature <= 0
        if not gated and got[rid] != exact[rid]:
            fail(f"{tag} {rid}: sampled tokens differ from the in-process "
                 f"engine's: {got[rid]} vs {exact[rid]}")
        if got[rid] == want:
            continue
        j = next((j for j, (a, b) in enumerate(zip(got[rid], want))
                  if a != b), None)
        if j is None:
            fail(f"{tag} {rid}: {len(got[rid])} tokens, solo {len(want)}")
        margin = draw_margin(params, cfg, prompt + want[:j], sp, j, device)
        print(f"[{tag}] {rid}: tokens differ from the solo first at {j} "
              f"({'sampled' if sp.temperature > 0 else 'greedy'}), solo "
              f"margin {margin}{'' if gated else ' (reported)'}")
        if gated and margin >= MARGIN:
            fail(f"{tag} {rid}: mismatch at token {j} with margin {margin}")
        near += 1
    return near


def sp_kwargs(sp) -> dict:
    return {"max_new_tokens": sp.max_new_tokens,
            "temperature": sp.temperature, "top_k": sp.top_k,
            "top_p": sp.top_p, "seed": sp.seed}


def fleet_wave(client, reqs, batch_first_half: bool = True,
               trigger=None, batch_all: bool = False,
               replica=None) -> dict:
    """Send ``reqs`` (the first half through one ``submit_many``, the rest
    through ``submit`` one by one; all of them through one ``submit_many``
    with ``batch_all``; every one through ``submit`` pinned to replica
    ``replica`` when it is given) and read every stream in a thread of
    its own. ``trigger = (when, action)``: ``action(handles)`` runs once
    ``when(handles, t_first)`` holds (``t_first``: request id -> the time
    its first token arrived), polled every 10 ms. Returns the tokens, each
    request's client-side TTFT and finish time, the handles and the wall
    seconds."""
    import threading

    t0 = time.perf_counter()
    half = (0 if replica is not None else len(reqs) if batch_all
            else len(reqs) // 2 if batch_first_half else 0)
    pin = {} if replica is None else {"replica": replica}
    handles, t_sub = {}, {}
    if half:
        out = client.submit_many(
            [p for _, p, _ in reqs[:half]],
            sampling=[dict(sp_kwargs(sp), request_id=rid)
                      for rid, _, sp in reqs[:half]])
        for (rid, _, _), h in zip(reqs[:half], out):
            if isinstance(h, Exception):
                fail(f"submit_many {rid}: {h!r}")
            handles[rid], t_sub[rid] = h, t0
    for rid, prompt, sp in reqs[half:]:
        t_sub[rid] = time.perf_counter()
        handles[rid] = client.submit(prompt, request_id=rid, **pin,
                                     **sp_kwargs(sp))
    toks = {rid: [] for rid, _, _ in reqs}
    t_first, t_end, errors = {}, {}, []

    def read(rid):
        try:
            for tok in client.stream_handle(handles[rid], timeout_s=600):
                if not toks[rid]:
                    t_first[rid] = time.perf_counter()
                toks[rid].append(tok)
            t_end[rid] = time.perf_counter()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"{rid}: {type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=read, args=(rid,), daemon=True)
               for rid, _, _ in reqs]
    for t in threads:
        t.start()
    if trigger is not None:
        when, action = trigger
        deadline = time.monotonic() + 600
        while not (errors or when(handles, dict(t_first))):
            if time.monotonic() > deadline:
                fail("the trigger's condition never held")
            time.sleep(0.01)
        action(handles)
    for t in threads:
        t.join(900)
    if errors or any(t.is_alive() for t in threads):
        fail(f"streams failed or hung: {errors}")
    for rid, _, sp in reqs:
        if len(toks[rid]) != sp.max_new_tokens:
            fail(f"{rid}: {len(toks[rid])} tokens of {sp.max_new_tokens}")
    return {"toks": toks, "handles": handles,
            "ttft": {rid: t_first[rid] - t_sub[rid] for rid in toks},
            "t_end": t_end, "wall": time.perf_counter() - t0}


def replica_counts(client, replicas=(0, 1)) -> dict:
    """Replica index -> its admissions, K1 launches, compiled_count and
    graphs captured since construction, for each of ``replicas`` (one
    stats RPC each)."""
    out = {}
    for i in replicas:
        s = client._rpc(i, "stats")
        out[i] = {"admitted": s["admitted"],
                  "launches": s["kernels"]["launches"],
                  "compiled_count": s["compiled_count"],
                  "compiles_since_init": s["compiles_since_init"],
                  "finished": s["finished"]}
    return out


def check_replica_counts(tag, before, after, cfg, cuda: bool,
                         phase: str = "serve-fleet") -> int:
    """Gates on each replica's counts over a stretch of traffic (``before``
    and ``after`` from :func:`replica_counts`): the graphs frozen
    (compiled_count unchanged, nothing captured since construction) and,
    on the card, 12 K1 launches per admission. Returns the K1 launches of
    the stretch."""
    total = 0
    for i, b in after.items():
        a = before[i]
        adm = b["admitted"] - a["admitted"]
        launches = b["launches"] - a["launches"]
        total += launches
        print(f"[{phase}] {tag} replica {i}: {adm} admissions, K1 "
              f"launches {launches}, compiled_count {b['compiled_count']}, "
              f"graphs captured since construction "
              f"{b['compiles_since_init']}")
        if (b["compiled_count"] != a["compiled_count"]
                or b["compiles_since_init"] != 0):
            fail(f"{tag} replica {i}: graphs moved: {a} -> {b}")
        if cuda and launches != adm * cfg.n_layer:
            fail(f"{tag} replica {i}: K1 launches {launches} != "
                 f"{cfg.n_layer} x {adm} admissions")
    return total


def spawn_seconds(t0: float, n: int) -> list:
    """Seconds each of the fleet's ``n`` replicas took to come up (process,
    imports, weights, kernel load, graph capture), from the fabric's
    ``actor_start`` events after ``t0`` (wall clock)."""
    from ray_lightning_tpu_torch.obs.events import get_event_log

    starts = [e["ts"] for e in get_event_log().tail(256, subsystem="fabric",
                                                    name="actor_start")
              if e["ts"] >= t0][-n:]
    return [b - a for a, b in zip([t0] + starts, starts)]


def serve_fleet_run(params, cfg, device, workdir: str, engine,
                    store_dir: str) -> dict:
    """The serve-fleet traffic (see ``phase_serve_fleet``) on ``device``:
    the replicas run there, half a card each; ``engine`` is an in-process
    engine of the replicas' configuration (the serve phase's) on the same
    weights; (b) writes through to the KV object store ``store_dir``,
    which serve-kvplane reads back. On the CPU (a rehearsal at a
    tiny width) set ``RLT_NUM_GPUS`` so the fabric has a card to share
    out; the launch gate then checks nothing (the CPU counts no launch)."""
    import dataclasses

    from ray_lightning_tpu_torch import fabric
    from ray_lightning_tpu_torch.models.gpt import params_to
    from ray_lightning_tpu_torch.obs.registry import get_registry
    from ray_lightning_tpu_torch.serve.client import start_replicas
    from ray_lightning_tpu_torch.serve.router import Router
    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams
    from ray_lightning_tpu_torch.utils.state_stream import (
        state_stream_to_file, to_state_stream)

    import numpy as np
    import torch

    cuda = torch.device(device).type == "cuda"
    ckpt = os.path.join(workdir, "gpt.ckpt")
    state_stream_to_file(to_state_stream({
        "params": params_to(params, torch.device("cpu")),
        "gpt_config": dataclasses.asdict(cfg)}), ckpt)
    out = {}
    solos = {}
    fabric.init()
    try:
        # -- (a) the monolithic fleet ---------------------------------------
        t0 = time.time()
        client = start_replicas(
            2, num_gpus_per_replica=FLEET_GPUS, ckpt_path=ckpt,
            device=device, rpc_timeout_s=120.0, init_timeout=600.0,
            **SERVE_ENGINE)
        out["spawn_s_mono"] = spawn_seconds(t0, 2)
        cards = [client._actor(i).visible_cards for i in range(2)]
        if cuda:
            out["card_mib_mono"] = card_memory_mib()
        print(f"[serve-fleet] (a) replicas up in {out['spawn_s_mono']} s on "
              f"cards {cards}; card memory {out.get('card_mib_mono')} MiB; "
              f"compute apps: {compute_apps() if cuda else 'n/a'}")
        if cards != [["0"], ["0"]]:
            fail(f"half-card replicas landed on {cards}, not one card")
        client.router = Router(client=client)
        rng = np.random.default_rng(0)
        reqs = serve_workload(cfg.vocab_size, rng)
        again = [(f"{rid}n", p, dataclasses.replace(sp, seed=sp.seed + 100))
                 for rid, p, sp in reqs]
        wave1 = reqs + again
        before = replica_counts(client)
        w1 = fleet_wave(client, wave1)
        after = replica_counts(client)
        launches = check_replica_counts("(a) wave 1", before, after, cfg,
                                        cuda)
        if min(after[i]["finished"] - a["finished"]
               for i, a in before.items()) <= 0:
            fail(f"a replica took no request: {before} -> {after}")
        stats = client.stats()
        # The in-process engine of the serve phase, on the same requests:
        # the replicas' arithmetic, in the driver.
        exact = serve_run(engine, wave1)["toks"]
        same = sum(w1["toks"][rid] == exact[rid] for rid, _, _ in wave1)
        print(f"[serve-fleet] (a) wave 1: {same} of {len(wave1)} requests "
              "bitwise the in-process engine's")
        near = fleet_compare("serve-fleet (a)", wave1, w1["toks"], params,
                             cfg, device, solos, exact)
        ttfts = sorted(w1["ttft"].values())
        n_tok = sum(len(t) for t in w1["toks"].values())
        out["mono"] = {
            "requests": len(wave1),
            "routes": [sum(h.replica == i for h in w1["handles"].values())
                       for i in range(2)],
            "near_tie_mismatches": near,
            "ttft_p50_s": ttfts[len(ttfts) // 2],
            "ttft_max_s": ttfts[-1],
            "tokens_per_s": n_tok / w1["wall"],
            "wall_s": w1["wall"],
            "replica_ms_per_fold_p50": [
                1e3 * s.get("step_time_p50_s", float("nan")) for s in stats],
            "replica_ttft_p50_s": [s.get("ttft_p50_s") for s in stats],
            "kernel_build_s": [s["kernels"]["build_s"] for s in stats],
        }
        print(f"[serve-fleet] (a) wave 1: {json.dumps(out['mono'])}")

        # The failover wave: the same requests again, round-robin (no
        # router: its affinity could keep them all off replica 1); replica
        # 1's folds wait, and it is killed once every stream has its first
        # token.
        client.router = None
        reg = get_registry()
        moved0 = reg.counter("rlt_serve_failover_requests_total").value(
            outcome="resubmitted")
        lost0 = reg.counter("rlt_serve_failover_requests_total").value(
            outcome="lost")
        client.inject_fault(1, [
            {"point": "fold_boundary", "action": "delay",
             "seconds": FLEET_FOLD_DELAY_S, "after": k}
            for k in range(1, 200)])
        wave2 = [(f"{rid}k", p, sp) for rid, p, sp in wave1]
        kill = {}

        def first_on_1(handles, t_first):
            return any(client._route_of(handles[rid]) == 1
                       for rid in t_first)

        def kill_replica_1(handles):
            with client._lock:
                kill["victims"] = sorted(
                    rid for rid in handles if client._route.get(rid) == 1)
            kill["t"] = time.perf_counter()
            fabric.kill(client._actor(1))
            client.on_replica_lost(1, reason="killed by the smoke")

        before = replica_counts(client, (0,))
        w2 = fleet_wave(client, wave2, trigger=(first_on_1, kill_replica_1))
        after = replica_counts(client, (0,))
        moved = reg.counter("rlt_serve_failover_requests_total").value(
            outcome="resubmitted") - moved0
        lost = reg.counter("rlt_serve_failover_requests_total").value(
            outcome="lost") - lost0
        launches += check_replica_counts("(a) failover", before, after, cfg,
                                         cuda)
        near2 = fleet_compare("serve-fleet (a) failover",
                              [(f"{rid}k", p, sp) for rid, p, sp in wave1],
                              w2["toks"], params, cfg, device, solos,
                              {f"{rid}k": t for rid, t in exact.items()})
        if not kill["victims"] or moved != len(kill["victims"]) or lost:
            fail(f"failover: victims {kill['victims']}, resubmitted {moved},"
                 f" lost {lost}")
        on_0 = sum(h.replica == 0 for h in w2["handles"].values())
        admitted = after[0]["admitted"] - before[0]["admitted"]
        if admitted != on_0 + len(kill["victims"]):
            fail(f"failover: replica 0 admitted {admitted}, not its {on_0} "
                 f"and the {len(kill['victims'])} resubmitted")
        out["failover"] = {
            "victims": len(kill["victims"]), "resubmitted": moved,
            "lost": lost, "near_tie_mismatches": near2,
            "seconds_kill_to_last_token": max(
                w2["t_end"][r] for r in kill["victims"]) - kill["t"],
        }
        print(f"[serve-fleet] (a) failover: {json.dumps(out['failover'])}")
        client.shutdown()
        out["launches"] = launches

        # -- (b) the prefix-cached fleet, the KV plane on --------------------
        t0 = time.time()
        client = start_replicas(
            2, num_gpus_per_replica=FLEET_GPUS, ckpt_path=ckpt,
            device=device, rpc_timeout_s=120.0, init_timeout=600.0,
            kvstore_dir=store_dir, kvstore_writethrough=True,
            max_prefills_per_step=len(FLEET_STEER_SUFFIXES), **FLEET_KV,
            **FLEET_CHUNKED_ENGINE)
        if not all(s.get("kvfleet") and s.get("kvstore")
                   for s in client.stats()):
            fail("(b): a replica runs without the KV plane or the store")
        out["spawn_s_chunked"] = spawn_seconds(t0, 2)
        if cuda:
            out["card_mib_chunked"] = card_memory_mib()
        client.router = Router(client=client,
                               prefix_block=FLEET_CHUNKED_ENGINE[
                                   "prefix_block"])
        work = chunked_workload(cfg.vocab_size)
        system = work["greedy"][0][:CHUNKED_SYSTEM]
        sps = ([SamplingParams(max_new_tokens=SERVE_NEW)]
               * len(work["greedy"])
               + [SamplingParams(max_new_tokens=SERVE_NEW, temperature=0.8,
                                 top_k=50, top_p=0.9, seed=i)
                  for i in range(len(work["sampled"]))])
        suffixes = [(f"p{i}", p, sp) for i, (p, sp) in enumerate(
            zip(work["greedy"] + work["sampled"], sps))]
        affinity0 = reg.counter("rlt_router_routed_total").value(
            reason="affinity")
        before = replica_counts(client)
        first = fleet_wave(client, [("sys", system, SamplingParams(
            max_new_tokens=SERVE_NEW))], batch_first_half=False)
        warm = first["handles"]["sys"].replica
        got, replicas = {}, []
        for req in suffixes:
            w = fleet_wave(client, [req], batch_first_half=False)
            got.update(w["toks"])
            replicas.append(w["handles"][req[0]].replica)
        after = replica_counts(client)
        check_replica_counts("(b)", before, after, cfg, False)
        affinity = reg.counter("rlt_router_routed_total").value(
            reason="affinity") - affinity0
        prefix = [s["prefix"] for s in client.stats()]
        ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
        got.update(first["toks"])
        near3 = fleet_compare(
            "serve-fleet (b)",
            [("sys", system, SamplingParams(max_new_tokens=SERVE_NEW))]
            + suffixes, got, params, ref_cfg, device, {})
        hits = [p["hit_tokens"] for p in prefix]
        out["prefix"] = {"warm_replica": warm, "suffix_replicas": replicas,
                         "affinity_routes": affinity, "hit_tokens": hits,
                         "near_tie_mismatches": near3,
                         "launches": sum(after[i]["launches"]
                                         - a["launches"]
                                         for i, a in before.items())}
        print(f"[serve-fleet] (b) {json.dumps(out['prefix'])}")
        if set(replicas) != {warm} or affinity != len(suffixes):
            fail(f"(b): suffixes went to {replicas} ({affinity} by "
                 f"affinity), the prefix is on replica {warm}")
        if (hits[warm] != CHUNKED_SYSTEM * len(suffixes)
                or hits[1 - warm] != 0):
            fail(f"(b): prefix hit tokens {hits}, want "
                 f"{CHUNKED_SYSTEM} x {len(suffixes)} on replica {warm}")
        if out["prefix"]["launches"]:
            fail("(b): the chunked path launched K1")
        out["prefix"]["toks"] = got
        out["prefix"]["requests"] = [("sys", system, SamplingParams(
            max_new_tokens=SERVE_NEW))] + suffixes
        out["steered"] = fleet_steered(client, warm, system, params,
                                       ref_cfg, device, cfg)
        client.shutdown()
    finally:
        fabric.shutdown()
    return out


def fleet_steered(client, warm, system, params, ref_cfg, device, cfg) -> dict:
    """(b)'s steered wave (see FLEET_STEER_DELAY_S): the warm replica is
    slowed (a delay-only fault plan on its folds) and loaded (background
    requests pinned to it), and new suffixes of the system prompt, sent in
    one submit_many, go by the router's load weighting to the other
    replica, which fetches the system prompt's chain from the warm one.
    Gates: every suffix routed to the other replica, one fetch of 32
    blocks each, admitted warm (512 hit tokens each), greedy tokens equal
    the reference-attention solo but at near-ties, graphs frozen, no
    request lost."""
    import numpy as np

    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams

    cold = 1 - warm
    rng = np.random.default_rng(11)
    rows = [client._rpc(i, "stats") for i in (0, 1)]
    kv0 = rows[cold]["kvfleet"]
    hit0 = rows[cold]["prefix"]["hit_tokens"]
    before = replica_counts(client)
    client.inject_fault(warm, [
        {"point": "fold_boundary", "action": "delay",
         "seconds": FLEET_STEER_DELAY_S, "after": k} for k in range(1, 400)])
    background = []
    for i in range(FLEET_STEER_LOAD):
        prompt = rng.integers(0, cfg.vocab_size, 16).tolist()
        background.append(client.submit(
            prompt, replica=warm, request_id=f"g{i}",
            max_new_tokens=SERVE_NEW))
    deadline = time.monotonic() + 120
    while True:
        row = client._rpc(warm, "stats")
        if row["queue_depth"] + row["active_slots"] >= FLEET_STEER_LOAD // 2:
            break
        if time.monotonic() > deadline:
            fail(f"(b) steered: the warm replica never loaded: {row}")
        time.sleep(0.05)
    client.router.refresh(force=True)
    steered = [(f"t{i}", system + rng.integers(0, cfg.vocab_size,
                                              n).tolist(),
                SamplingParams(max_new_tokens=SERVE_NEW))
               for i, n in enumerate(FLEET_STEER_SUFFIXES)]
    w = fleet_wave(client, steered, batch_all=True)
    client.inject_fault(warm, None)
    for h in background:
        n = len(list(client.stream_handle(h, timeout_s=600)))
        if n != SERVE_NEW:
            fail(f"(b) steered: background {h.request_id} gave {n} tokens")
    after = replica_counts(client)
    check_replica_counts("(b) steered", before, after, cfg, False)
    row = client._rpc(cold, "stats")
    kv1 = row["kvfleet"]
    routes = [w["handles"][rid].replica for rid, _, _ in steered]
    fetches = kv1["fetches"] - kv0["fetches"]
    blocks = kv1["fetch_blocks"] - kv0["fetch_blocks"]
    nbytes = kv1["fetch_bytes"] - kv0["fetch_bytes"]
    hits = row["prefix"]["hit_tokens"] - hit0
    phase = (row.get("phases") or {}).get("by_phase", {}).get("kv_fetch", {})
    near = fleet_compare("serve-fleet (b) steered", steered, w["toks"],
                         params, ref_cfg, device, {})
    res = {
        "warm_replica": warm, "routes": routes, "fetches": fetches,
        "fetch_blocks": blocks, "fetch_bytes": nbytes,
        "fetch_timeouts": kv1["fetch_timeouts"] - kv0["fetch_timeouts"],
        "fetch_stale": kv1["fetch_stale"] - kv0["fetch_stale"],
        "fetch_refused": kv1["fetch_refused"] - kv0["fetch_refused"],
        "hit_tokens": hits, "kv_fetch_phase_s": phase,
        "fetch_mb_per_s": (nbytes / fetches / 2**20 / phase["p50_s"]
                           if fetches and phase.get("p50_s") else None),
        "ttft_s": {rid: w["ttft"][rid] for rid, _, _ in steered},
        "near_tie_mismatches": near,
    }
    print(f"[serve-fleet] (b) steered: {json.dumps(res)} on {card_line()}")
    n = len(steered)
    if routes != [cold] * n:
        fail(f"(b) steered: suffixes went to {routes}, want replica {cold}")
    if fetches != n or blocks != 32 * n or res["fetch_timeouts"]:
        fail(f"(b) steered: {fetches} fetches of {blocks} blocks "
             f"({res['fetch_timeouts']} timed out), want {n} of 32 each")
    if hits != CHUNKED_SYSTEM * n:
        fail(f"(b) steered: {hits} prefix hit tokens, want "
             f"{CHUNKED_SYSTEM} x {n}")
    return res


def phase_serve_fleet(serve4: dict) -> int:
    """The serving fleet's front door on one card: GPT-2 small at full
    width and depth (random weights from the smoke's seed, written once to
    a checkpoint under ``build/smoke_fleet`` that every replica loads),
    ``fabric.init`` with ``RLT_REQUIRE_GPU=1``, and two fleets of two
    half-card replicas through ``start_replicas`` -> ``ServeClient`` ->
    ``Router`` -> ``ServeReplica`` -> ``Scheduler`` -> ``DecodeEngine``
    (``serve_fleet_run``). Gates: every request finishes with its count;
    (a)'s tokens bitwise the serve phase's in-process engine's on the
    same requests, greedy tokens (and (b)'s sampled ones) equal the solo
    ``gpt_generate`` with the request's seed except at near-ties
    (``draw_margin``); both replicas served; every replica's graphs
    frozen; 12 K1 launches per admission;
    the killed replica's requests all resubmitted onto the survivor, 0
    lost; every prefix-sharing suffix routed by affinity to the warm
    replica with 512 prefix tokens hit each, none on the other; the
    steered suffixes fetched from it (``fleet_steered``); no child
    process left and the card's used memory back within
    ``FLEET_MEM_SLACK_MIB`` of where it was. Returns K1's launches in the
    replicas and the hand-over serve-kvplane needs (the checkpoint, (b)'s
    store directory, requests and tokens)."""
    import torch

    from ray_lightning_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init_gpt_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    workdir = os.path.join(HERE, "build", "smoke_fleet")
    store_dir = os.path.join(HERE, "build", "smoke_kvstore")
    for d in (workdir, store_dir):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(workdir)
    os.environ["RLT_REQUIRE_GPU"] = "1"
    kids0 = child_pids()
    mem0 = card_memory_mib()
    try:
        out = serve_fleet_run(params, cfg, "cuda", workdir,
                              serve4["sched"].engine, store_dir)
    except BaseException:
        for d in (workdir, store_dir):
            shutil.rmtree(d, ignore_errors=True)
        raise
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and (
            set(child_pids()) - set(kids0)
            or card_memory_mib() > mem0 + FLEET_MEM_SLACK_MIB):
        time.sleep(0.5)
    kids, mem = set(child_pids()) - set(kids0), card_memory_mib()
    print(f"[serve-fleet] after shutdown: children {sorted(kids)}, card "
          f"memory {mem} MiB (before the phase {mem0} MiB), compute apps: "
          f"{compute_apps()}")
    if kids:
        fail(f"child processes left after shutdown: {sorted(kids)}")
    if mem > mem0 + FLEET_MEM_SLACK_MIB:
        fail(f"card memory {mem} MiB after the phase, {mem0} MiB before")
    single = sum(len(t) for t in serve4["toks"].values()) / serve4["wall"]
    summary = {
        "spawn_s": out["spawn_s_mono"] + out["spawn_s_chunked"],
        "ttft_p50_s": out["mono"]["ttft_p50_s"],
        "ttft_max_s": out["mono"]["ttft_max_s"],
        "fleet_tokens_per_s": out["mono"]["tokens_per_s"],
        "single_engine_tokens_per_s_phase_serve": single,
        "replica_ms_per_fold_p50": out["mono"]["replica_ms_per_fold_p50"],
        "failover_s": out["failover"]["seconds_kill_to_last_token"],
        "card_mib": [mem0, out["card_mib_mono"], out["card_mib_chunked"],
                     mem],
        "steered_fetch_s_p50": out["steered"]["kv_fetch_phase_s"].get(
            "p50_s"),
        "steered_fetch_mb_per_s": out["steered"]["fetch_mb_per_s"],
    }
    print(f"[serve-fleet] {json.dumps(summary)} on {card_line()}")
    # serve-kvplane bounces a fleet on (b)'s checkpoint and store, and
    # removes both.
    fleet = {"params": params, "cfg": cfg, "ckpt": os.path.join(
        workdir, "gpt.ckpt"), "workdir": workdir, "store_dir": store_dir,
        "prefix": out["prefix"]}
    return out["launches"], fleet


#: The serve-kvplane phase: in process, two engines of the serve-chunked
#: configuration (pool, host tier, no disk tier) and one of the serve-paged
#: configuration, each with its own Scheduler and KVFleetPlane, joined by
#: queue.Queue inboxes; then, on the fabric, a fresh disaggregated fleet
#: (a prefill and a decode replica) on serve-fleet (b)'s checkpoint and
#: KV object store. A layer-wise ship is cut after KVPLANE_ABORT_LAYER of
#: the 12 layers; the fabric fleet serves the system prompt and the first
#: KVPLANE_FABRIC_SUFFIXES of (b)'s suffixes.
KVPLANE_ENGINE = FLEET_CHUNKED_ENGINE
KVPLANE_ABORT_LAYER = 6
KVPLANE_FABRIC_SUFFIXES = 4


class _Timer:
    """Wraps ``obj.name`` with a wall clock (the card synced before the
    clock stops, on the card); the seconds of each call in ``secs``."""

    def __init__(self, obj, name: str, sync) -> None:
        self.secs, self._fn, self._sync = [], getattr(obj, name), sync
        setattr(obj, name, self)

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        self._sync()
        self.secs.append(time.perf_counter() - t0)
        return out


def serve_kvplane_run(params, cfg, device, fleet: dict) -> dict:
    """The serve-kvplane traffic on ``device`` (see
    ``phase_serve_kvplane``); ``fleet`` is serve-fleet's hand-over (its
    checkpoint, its store directory and (b)'s requests and tokens). On
    the CPU (a rehearsal at a tiny width) the K1 row check compares the
    plain forward and the fabric half runs CPU replicas (set
    ``RLT_NUM_GPUS``)."""
    import dataclasses
    import queue

    import numpy as np
    import torch

    from ray_lightning_tpu_torch import fabric
    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.obs.registry import get_registry
    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.serve.client import start_replicas
    from ray_lightning_tpu_torch.serve.kvfleet import KVFleetPlane
    from ray_lightning_tpu_torch.serve.kvstore import FleetKVStore
    from ray_lightning_tpu_torch.serve.router import (
        Router,
        prompt_block_digests,
    )
    from ray_lightning_tpu_torch.serve.scheduler import (
        SamplingParams,
        Scheduler,
    )

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    out: dict = {}
    bs = KVPLANE_ENGINE["prefix_block"]
    work = chunked_workload(cfg.vocab_size)
    system = work["greedy"][0][:CHUNKED_SYSTEM]
    rng = np.random.default_rng(7)

    def draw(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    inboxes = {i: queue.Queue() for i in range(3)}
    roles = ("prefill", "decode", "mixed")
    engines, planes, scheds = [], [], []
    for i, kw in enumerate((KVPLANE_ENGINE, KVPLANE_ENGINE, PAGED_ENGINE)):
        eng = new_engine(params, cfg, device=device, **kw)
        plane = KVFleetPlane(
            index=i, role=roles[i], inbox=inboxes[i], peers=dict(inboxes),
            block_bytes=eng.prefix_block_nbytes, timeout_s=30.0,
            max_inflight_mb=256.0, min_poll_s=0.0)
        engines.append(eng)
        planes.append(plane)
        scheds.append(Scheduler(eng, kvfleet=plane, role=roles[i],
                                **CHUNKED_SCHED))
    e0, e1, e2 = engines
    t_export = _Timer(e0, "export_prefix_blocks", sync)
    t_ship = _Timer(planes[0], "ship", sync)
    t_import = _Timer(e1, "import_prefix_blocks", sync)
    t_layer = _Timer(e1, "import_prefix_block_layer", sync)
    toks, ttft, reasons = {}, {}, {}

    def drive(idx, until=None):
        busy = True
        while busy and not (until and until()):
            busy = False
            for i in idx:
                if not scheds[i].has_work():
                    continue
                busy = True
                for ev in scheds[i].step():
                    t = time.perf_counter()
                    if ev.token is not None:
                        toks.setdefault(ev.request_id, []).append(ev.token)
                        ttft.setdefault(ev.request_id, t)
                    if ev.done:
                        reasons[ev.request_id] = (ev.reason, ev.ship_to)

    def run(i, rid, prompt, idx=None, **kw):
        """Submit ``rid`` on engine ``i`` and drive ``idx`` (``i``) to
        idle; the tokens, and the slot the request took."""
        slot = engines[i].free_slots()[0]
        t0 = time.perf_counter()
        scheds[i].submit(prompt, SamplingParams(max_new_tokens=SERVE_NEW),
                         request_id=rid, **kw)
        drive(idx or (i,))
        ttft[rid] -= t0
        return toks[rid], slot

    def hint(prompt, peer=None, store=False, run=None):
        digs = [d.hex() for d in prompt_block_digests(prompt, bs)][:run]
        return ({"peer": None, "store": True, "digests": digs}
                if store else {"peer": peer, "digests": digs})

    k1_err, k1_launches = {}, [0]

    def k1_rows(tag, eng, slot, prompt):
        """The receiver's K/V rows against K1's flash prefill (which runs
        none of the chunk's code) of the prompt's longest head whose
        length K1 takes (a multiple of its 128-row tile): the rows of a
        causal prefix depend on that prefix alone, and they are the rows
        the transfer brought."""
        c0 = counters.launches
        n = len(prompt) // 128 * 128
        with torch.no_grad():
            _, fk, fv = gpt.gpt_prefill(
                eng.params, cfg, torch.tensor([prompt[:n]], device=device))
        k1_err[tag] = max(kv_row_err(eng._k[:, slot, :n], fk[:, 0]),
                          kv_row_err(eng._v[:, slot, :n], fv[:, 0]))
        k1_launches[0] += counters.launches - c0

    def same_blocks(a, b, hexes):
        """Every digest's block bitwise equal in the two engines (the
        holder's copy and the receiver's import, from whichever tier
        holds each now)."""
        for h in hexes:
            d = bytes.fromhex(h)
            ka, kb = a._export_block(d), b._export_block(d)
            if ka is None or kb is None:
                fail(f"block {h} missing: holder {ka is not None}, "
                     f"receiver {kb is not None}")
            if not all(torch.equal(x, y) for x, y in zip(ka, kb)):
                fail(f"block {h}: the receiver's copy differs")
        return len(hexes)

    def fetch_phase(i):
        return scheds[i].metrics.phase_records()[-1].get("kv_fetch", 0.0)

    def plane_delta(i, before):
        now = planes[i].stats()
        return {k: now[k] - before[k] for k in (
            "fetches", "fetch_blocks", "fetch_bytes", "fetch_timeouts",
            "fetch_stale", "fetch_refused", "ships", "ship_blocks",
            "ship_bytes", "layer_ships", "layer_ship_messages",
            "ship_partial_drops", "store_fetches", "store_fetch_blocks",
            "store_fetch_bytes", "store_fetch_misses", "imports")}

    counters.reset()
    sfx = work["greedy"]
    # Local runs on engine 0: a0 cold (the system prompt is computed),
    # a1..a5 warm on it; the tokens every transfer must reproduce.
    for j in range(6):
        run(0, f"a{j}", sfx[j])

    # -- peer fetch: dense -> dense, dense -> paged -------------------------
    p0 = planes[1].stats()
    h1 = hint(sfx[1], peer=0)
    got, slot = run(1, "f1", sfx[1], idx=(0, 1), kv_hint=h1)
    fetch = {"dense": plane_delta(1, p0)}
    fetch["dense"]["seconds"] = fetch_phase(1)
    if got != toks["a1"]:
        fail(f"peer fetch: tokens {got} != the holder's {toks['a1']}")
    fetch["dense"]["same_blocks"] = same_blocks(e0, e1, h1["digests"])
    k1_rows("fetch", e1, slot, sfx[1])
    p0 = planes[2].stats()
    h2 = hint(sfx[2], peer=0)
    got, _ = run(2, "p2", sfx[2], idx=(0, 2), kv_hint=h2)
    fetch["paged"] = plane_delta(2, p0)
    fetch["paged"]["seconds"] = fetch_phase(2)
    if got != toks["a2"]:
        fail(f"paged fetch: tokens {got} != the holder's {toks['a2']}")
    fetch["paged"]["same_blocks"] = same_blocks(e0, e2, h2["digests"])
    for kind, f in fetch.items():
        f["mb_per_s"] = f["fetch_bytes"] / 2**20 / f["seconds"]
        if (f["fetches"] != 1 or f["fetch_blocks"] != len(h1["digests"] if
                                                          kind == "dense" else
                                                          h2["digests"])
                or f["fetch_timeouts"] or f["fetch_stale"]):
            fail(f"{kind} fetch: {f}")
    out["fetch"] = fetch

    # -- disaggregated ships: whole, then one message per layer -------------
    ships = {}
    for layerwise, j in ((False, 3), (True, 4)):
        for p in planes:
            p.layerwise_ship = layerwise
        rid = f"s{j}"
        n_exp, n_ship, n_imp, n_lay = (len(t.secs) for t in (
            t_export, t_ship, t_import, t_layer))
        l0 = e1.layer_block_imports
        p0 = planes[0].stats()
        t0 = time.perf_counter()
        scheds[0].submit(sfx[j], SamplingParams(max_new_tokens=SERVE_NEW),
                         request_id=rid, ship_to=1)
        drive((0, 1))
        land_s = time.perf_counter() - t0
        first = list(toks[rid])
        if reasons[rid] != ("shipped", 1) or len(first) != 1:
            fail(f"ship {rid}: {reasons[rid]} with {len(first)} tokens")
        toks.pop(rid)
        ttft.pop(rid)
        got, slot = run(1, rid, sfx[j])
        if got != toks[f"a{j}"] or got[0] != first[0]:
            fail(f"ship {rid}: tokens {got} != the local run's")
        k1_rows("ship_layers" if layerwise else "ship", e1, slot, sfx[j])
        d = plane_delta(0, p0)
        ships["layers" if layerwise else "whole"] = {
            "blocks": d["ship_blocks"], "bytes": d["ship_bytes"],
            "messages": d["layer_ship_messages"],
            "export_s": sum(t_export.secs[n_exp:]),
            "ship_s": sum(t_ship.secs[n_ship:]),
            "import_s": sum(t_import.secs[n_imp:])
            + sum(t_layer.secs[n_lay:]),
            "prefill_to_import_s": land_s,
            "layer_block_imports": e1.layer_block_imports - l0,
        }
        if layerwise and d["layer_ship_messages"] != cfg.n_layer:
            fail(f"layer-wise ship: {d['layer_ship_messages']} messages")
    out["ship"] = ships

    # -- a layer-wise ship cut after KVPLANE_ABORT_LAYER layers -------------
    fresh = work["fresh"]
    p1 = planes[1].stats()
    a0_, hit0 = e1.layer_import_aborts, e1.prefix_hit_tokens
    scheds[0].submit(fresh, SamplingParams(max_new_tokens=SERVE_NEW),
                     request_id="x", ship_to=1)
    drive((0,))
    for p in planes:
        p.layerwise_ship = False
    kept = []
    while not inboxes[1].empty():
        kind, body = inboxes[1].get_nowait()
        if kind == "ship_layer" and body["layer"] >= min(
                KVPLANE_ABORT_LAYER, cfg.n_layer - 1):
            continue
        kept.append((kind, body))
    for item in kept:
        inboxes[1].put(item)
    planes[1].timeout_s = 1.0
    scheds[1].step()
    staged = len(e1._layer_imports)
    if staged != len(fresh) // bs or e1.prefix_hit_tokens != hit0:
        fail(f"cut ship: {staged} blocks staged, hits moved")
    time.sleep(1.2)
    scheds[1].step()  # the deadline sweep aborts the staging
    planes[1].timeout_s = 30.0
    aborted = e1.layer_import_aborts - a0_
    toks.pop("x")
    ttft.pop("x")
    got, _ = run(1, "x", fresh)
    ref, _ = run(0, "xl", fresh)
    cut = {"staged_blocks": staged, "aborted_blocks": aborted,
           "partial_drops": plane_delta(1, p1)["ship_partial_drops"],
           "hit_tokens": e1.prefix_hit_tokens - hit0}
    if got != ref or aborted != staged or cut["hit_tokens"]:
        fail(f"cut ship: {cut}, tokens equal {got == ref}")
    out["cut_ship"] = cut

    # -- write-through, then a bounce onto a fresh store handle -------------
    root = os.path.join(os.path.dirname(fleet["store_dir"]),
                        "smoke_kvplane_store")
    shutil.rmtree(root, ignore_errors=True)
    store = FleetKVStore(root, registry=get_registry())
    t_put = _Timer(store, "put_block", sync)
    scheds[0].kvstore, scheds[0].kvstore_writethrough = store, True
    q = work["flood"][0] + draw(40)
    q2 = draw(CHUNKED_SYSTEM + 24)
    wq, _ = run(0, "wq", q)
    wq2, _ = run(0, "wq2", q2)
    bounce = FleetKVStore(root)  # the fresh fleet's handle
    t_get = _Timer(bounce, "get_chain", sync)
    planes[1].store = bounce
    scheds[1].kvstore = bounce
    manifest = set(bounce.manifest())
    hq = hint(q, store=True)
    if not set(hq["digests"]) <= manifest:
        fail("the store's manifest lacks the written-through chain")
    p1, hit0 = planes[1].stats(), e1.prefix_hit_tokens
    got, slot = run(1, "bq", q, kv_hint=hq)
    st = plane_delta(1, p1)
    if (got != wq or st["store_fetches"] != 1 or st["store_fetch_misses"]
            or st["store_fetch_blocks"] != len(hq["digests"])):
        fail(f"store bounce: {st}, tokens equal {got == wq}")
    k1_rows("store", e1, slot, q)
    out["store"] = {
        "writes": store.writes, "put_s_per_block": sum(t_put.secs)
        / max(1, len(t_put.secs)),
        "bytes_per_block": store.bytes_written / max(1, store.writes),
        "get_s_per_block": sum(t_get.secs) / st["store_fetch_blocks"],
        "fetch_s": fetch_phase(1), "hit_tokens": e1.prefix_hit_tokens - hit0,
    }

    # -- a parked session restored on another engine ------------------------
    c1 = draw(300)
    t1, _ = run(0, "c1", c1)
    scheds[0].request_park(c1 + t1, request_id="c1")
    scheds[0].step()
    parked = scheds[0].park_result(timeout=60.0)
    if not parked or parked["stored"] != parked["blocks"] or (
            parked["freed"] != parked["blocks"]):
        fail(f"park: {parked}")
    c2 = c1 + t1 + draw(24)
    got, slot = run(1, "c2", c2, kv_hint=hint(c2, store=True,
                                              run=parked["blocks"]))
    ref, _ = run(0, "c2l", c2)
    if got != ref:
        fail("park: the restored turn's tokens differ from a local run")
    k1_rows("park", e1, slot, c2)
    out["park"] = {k: parked[k] for k in ("blocks", "stored", "freed")}

    # -- the store directory removed mid-fetch ------------------------------
    p1, hit0 = planes[1].stats(), e1.prefix_hit_tokens
    scheds[1].submit(q2, SamplingParams(max_new_tokens=SERVE_NEW),
                     request_id="mq2", kv_hint=hint(q2, store=True))
    scheds[1].step()  # parked on the store fetch
    shutil.rmtree(root)
    drive((1,))
    st = plane_delta(1, p1)
    if (toks["mq2"] != wq2 or st["store_fetch_misses"] != 1
            or e1.prefix_hit_tokens != hit0):
        fail(f"store removed mid-fetch: {st}")
    out["store_removed"] = {"misses": st["store_fetch_misses"],
                            "tokens_equal": True}
    for s in scheds:
        s.kvstore = None
    planes[1].store = None
    path_launches = counters.launches - k1_launches[0]
    print(f"[serve-kvplane] in process: K/V rows of every transfer vs the "
          f"flash prefill, largest relative row error (bar {KV_ROW_TOL}): "
          f"{json.dumps(k1_err)}")
    for tag, err in k1_err.items():
        if not err <= KV_ROW_TOL:
            fail(f"{tag}: K/V rows differ from the flash prefill by {err}")
    out["k1_check_launches"] = k1_launches[0]
    out["launches"] = path_launches
    out["ttft_s"] = {"cold": ttft["a0"], "warm_local": ttft["a1"],
                     "fetch": ttft["f1"], "store": ttft["bq"]}
    out["phases"] = scheds[1].metrics.snapshot().get("phases")
    print(f"[serve-kvplane] in process: {json.dumps(out)} on {card_line()}")
    if path_launches:
        fail("the chunked engines launched K1 on the transfer path")
    if cuda and k1_launches[0] != len(k1_err) * cfg.n_layer:
        fail(f"the row checks launched K1 {k1_launches[0]} times, not "
             f"{cfg.n_layer} per check")
    del engines, planes, scheds, e0, e1, e2

    # -- on the fabric: a fresh disaggregated fleet on (b)'s store ----------
    reg = get_registry()
    lost0 = reg.counter("rlt_serve_failover_requests_total").value(
        outcome="lost")
    fabric.init()
    try:
        t0 = time.time()
        client = start_replicas(
            2, num_gpus_per_replica=FLEET_GPUS, ckpt_path=fleet["ckpt"],
            device=device, rpc_timeout_s=120.0, init_timeout=600.0,
            roles=["prefill", "decode"], kvstore_dir=fleet["store_dir"],
            **FLEET_KV, **FLEET_CHUNKED_ENGINE)
        spawn = spawn_seconds(t0, 2)
        client.router = Router(client=client, prefix_block=bs)
        seeded = client.seed_store_directory()
        # The system prompt and suffixes of more than one block (a suffix
        # of one block is a pure prefix hit on the decode replica, which
        # the router sends there directly).
        reqs = [fleet["prefix"]["requests"][0]] + fleet["prefix"][
            "requests"][2:2 + KVPLANE_FABRIC_SUFFIXES]
        before = replica_counts(client)
        got, f_ttft = {}, {}
        for req in reqs:
            w = fleet_wave(client, [req], batch_first_half=False)
            got.update(w["toks"])
            f_ttft.update(w["ttft"])
        after = replica_counts(client)
        finished = [after[i]["finished"] - a["finished"]
                    for i, a in before.items()]
        check_replica_counts("serve-kvplane fleet", before, after, cfg,
                             False)
        rows = client.stats()
        plane = [r["kvfleet"] for r in rows]
        store_rows = [r["kvstore"] for r in rows]
        want = fleet["prefix"]["toks"]
        same = [rid for rid, _, _ in reqs if got[rid] == want[rid]]
        ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
        differ = [r for r in reqs if got[r[0]] != want[r[0]]]
        near = fleet_compare("serve-kvplane fleet", differ, got, params,
                             ref_cfg, device, {}) if differ else 0
        lost = reg.counter("rlt_serve_failover_requests_total").value(
            outcome="lost") - lost0
        fab = {
            "spawn_s": spawn, "seeded_digests": seeded,
            "finished_per_replica": finished, "same_as_fleet_b": len(same),
            "near_tie_mismatches": near, "lost": lost,
            "prefill_plane": plane[0], "decode_plane": plane[1],
            "store": [{k: s[k] for k in ("hits", "misses", "writes",
                                         "bytes_read")} for s in store_rows],
            "ttft_s": f_ttft,
            "decode_fetch_phase_s": (rows[1].get("phases") or {}).get(
                "by_phase", {}).get("kv_fetch"),
        }
        print(f"[serve-kvplane] fleet: {json.dumps(fab)} on {card_line()}")
        if not seeded:
            fail("seed_store_directory seeded nothing from (b)'s store")
        if (plane[0]["store_fetches"] < 1 or plane[0]["store_fetch_misses"]
                or plane[0]["store_fetch_blocks"] != CHUNKED_SYSTEM // bs):
            fail(f"the prefill replica did not admit from the store: "
                 f"{plane[0]}")
        if plane[0]["ships"] != len(reqs) or finished != [0, len(reqs)]:
            fail(f"ships {plane[0]['ships']}, finished per replica "
                 f"{finished}: every request must ship and finish on the "
                 "decode replica")
        if lost:
            fail(f"{lost} requests lost")
        out["fabric"] = fab
        client.shutdown()
    finally:
        fabric.shutdown()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def phase_serve_kvplane(fleet: dict) -> int:
    """The fleet KV plane and the KV object store at GPT-2-small width and
    depth (``serve_kvplane_run``). In process: a peer fetch (dense and
    paged receivers), a disaggregated ship (whole and layer-wise), a
    layer-wise ship cut mid-stream, a write-through and a bounce onto a
    fresh store handle, a parked session restored on another engine and
    the store directory removed mid-fetch. Gates: tokens bitwise the
    local run's; fetched blocks bitwise the holder's; the cut ship
    stages, aborts and decodes cold with nothing hit; the receivers'
    K/V rows within KV_ROW_TOL of the flash prefill (K1); every engine's
    graphs frozen; 0 K1 launches on the path. On the fabric: a fresh
    prefill/decode fleet on serve-fleet (b)'s checkpoint and store,
    seeded from the store's manifest, admits the system prompt from the
    store, ships every request to the decode replica, which the client
    follows; tokens equal (b)'s but at near-ties, 0 lost, graphs frozen.
    Removes (b)'s store afterwards (serve-recovery removes the checkpoint;
    both go if this phase fails). Returns K1's launches on the path."""
    kids0 = child_pids()
    try:
        out = serve_kvplane_run(fleet["params"], fleet["cfg"], "cuda", fleet)
    except BaseException:
        shutil.rmtree(fleet["workdir"], ignore_errors=True)
        raise
    finally:
        shutil.rmtree(fleet["store_dir"], ignore_errors=True)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and set(child_pids()) - set(kids0):
        time.sleep(0.5)
    kids = set(child_pids()) - set(kids0)
    if kids:
        fail(f"child processes left after shutdown: {sorted(kids)}")
    summary = {
        "fetch_s": {k: v["seconds"] for k, v in out["fetch"].items()},
        "fetch_mb_per_s": {k: v["mb_per_s"] for k, v in out["fetch"].items()},
        "ship_s": {k: v["prefill_to_import_s"] for k, v in out["ship"].items()},
        "store_put_s_per_block": out["store"]["put_s_per_block"],
        "store_get_s_per_block": out["store"]["get_s_per_block"],
        "store_bytes_per_block": out["store"]["bytes_per_block"],
        "ttft_s": out["ttft_s"],
        "k1_check_launches": out["k1_check_launches"],
        "path_k1_launches": out["launches"],
        "wall_s": out["wall_s"],
    }
    print(f"[serve-kvplane] {json.dumps(summary)} on {card_line()}")
    return out["launches"]


#: The serve-recovery phase (after serve-kvplane, on serve-fleet's
#: checkpoint). Fleet A, three replicas of the serve phase's engine at a
#: quarter of the card each, serves (a) and (b): (b)'s pre-spawned
#: replacement takes the fourth quarter outside A's placement group, so
#: the fabric's card accounting (not the card's memory) sets the share.
#: Three replicas keep two routable while one is excluded for its grace
#: window. Fleet C, one replica at a third of the card, serves (c) and
#: adds a second third. (d)'s head runs its own fabric, its replica at a
#: third of its one card, alongside (c).
RECOVERY_GPUS_A = 0.25
RECOVERY_GPUS_C = 1 / 3
#: The supervisor's tick and first backoff (s); a dead verdict must lead
#: to a restart attempt within RECOVERY_BACKOFF_S + 2 ticks.
RECOVERY_TICK_S = 0.25
RECOVERY_BACKOFF_S = 0.5
#: (b)'s grace window: longer than the drain and the pre-spawn together,
#: so the swap (not the fault's hard kill) ends the dying replica. The
#: dying replica's folds wait RECOVERY_DRAIN_DELAY_S each, so that the
#: drain, a supervisor tick after the notice, still finds a queue: at full
#: speed the card serves the whole wave in about half a second.
RECOVERY_GRACE_S = 60.0
RECOVERY_DRAIN_DELAY_S = 0.2
#: (c)'s burst: replica 0's folds wait this long each, for this many
#: folds, so its queue holds while the autoscaler ticks.
RECOVERY_BURST_DELAY_S = 0.1
RECOVERY_BURST_FOLDS = 60


def recovery_compare(tag, reqs, got, exact, params, cfg, device) -> int:
    """Each request's tokens against the serve phase's in-process engine
    (``exact``): bitwise, except that a greedy token may differ where the
    engine's own next token was a near-tie (serve-fleet's rule,
    ``draw_margin`` below MARGIN); sampled tokens must be bitwise. Returns
    how many requests differ."""
    near = 0
    for rid, prompt, sp in reqs:
        want = exact[rid]
        if got[rid] == want:
            continue
        j = next((j for j, (a, b) in enumerate(zip(got[rid], want))
                  if a != b), None)
        if j is None or sp.temperature > 0:
            fail(f"{tag} {rid}: tokens differ from the in-process engine's: "
                 f"{got[rid]} vs {want}")
        margin = draw_margin(params, cfg, prompt + want[:j], sp, j, device)
        print(f"[serve-recovery] {tag} {rid}: differs from the in-process "
              f"engine first at {j}, its margin {margin}")
        if margin >= MARGIN:
            fail(f"{tag} {rid}: mismatch at token {j} with margin {margin}")
        near += 1
    return near


def startup_breakdown(client, idx: int) -> dict:
    """Where replica ``idx``'s start-up went (s): the worker's exec and
    interpreter start, imports (torch and the package), the CUDA context,
    the checkpoint read, the engine's set-up (weights to the card, KV
    buffers), the kernel library's load, graph capture, the rest of the
    replica's constructor, and the way back to the driver; from its
    ``stats()["startup"]`` and the fabric's ``actor_start`` event (wall
    clock, one host)."""
    from ray_lightning_tpu_torch.obs.events import get_event_log

    s = client._rpc(idx, "stats")["startup"]
    actor = client._actor(idx).actor_id
    (ev,) = [e for e in get_event_log().tail(1024, subsystem="fabric",
                                             name="actor_start")
             if e.get("actor") == actor]
    inner = (s["cuda_context_s"] + s["weights_load_s"] + s["engine_setup_s"]
             + s["kernel_load_s"] + s["capture_s"])
    return {
        "process_start_s": s["worker_t0"] - ev["boot_ts"],
        "imports_s": s["imports_end"] - s["worker_t0"],
        "cuda_context_s": s["cuda_context_s"],
        "weights_load_s": s["weights_load_s"],
        "engine_setup_s": s["engine_setup_s"],
        "kernel_load_s": s["kernel_load_s"],
        "graph_capture_s": s["capture_s"],
        "rest_of_init_s": s["init_end"] - s["imports_end"] - inner,
        "to_driver_s": ev["ts"] - s["init_end"],
        "total_s": ev["ts"] - ev["boot_ts"],
    }


class _Sampler:
    """Samples ``fn()`` every 10 ms on a thread until stopped, and once more
    at the stop (the caller may stop it on a state it has just seen,
    before the thread's next sample): (wall time, value) pairs."""

    def __init__(self, fn):
        import threading

        self.fn, self.samples = fn, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            self.samples.append((time.time(), self.fn()))
            self._stop.wait(0.01)

    def stop(self):
        self._stop.set()
        self._thread.join(10)
        self.samples.append((time.time(), self.fn()))
        return self.samples


def event_ts(events, name, **match) -> list:
    return [e["ts"] for e in events.tail(1024, name=name)
            if all(e.get(k) == v for k, v in match.items())]


def recovery_crash(client, sup, sup_events, wave, exact, params, cfg,
                   device, cuda) -> dict:
    """(a): replica 1 killed by a fault at its 2nd fold boundary under the
    wave; failover, the supervisor's restart, a second wave pinned to the
    restarted replica."""
    from ray_lightning_tpu_torch.obs.events import get_event_log
    from ray_lightning_tpu_torch.obs.registry import get_registry

    reg = get_registry()
    lost0 = reg.counter("rlt_serve_failover_requests_total").value(
        outcome="lost")
    states = _Sampler(lambda: sup.rows()[1]["state"] if len(sup.rows()) > 1
                      else "healthy")
    old = client._actor(1)
    t_wave = time.time()
    before = replica_counts(client, (0, 2))
    client.inject_fault(1, [{"point": "fold_boundary", "action": "kill",
                             "after": 2}])
    w = fleet_wave(client, wave)
    after = replica_counts(client, (0, 2))
    launches = check_replica_counts("(a) crash wave", before, after, cfg,
                                    cuda, "serve-recovery")
    near = recovery_compare("(a) crash wave", wave, w["toks"], exact,
                            params, cfg, device)
    deadline = time.monotonic() + 600
    while not (sup.rows()[1]["restarts"] >= 1
               and sup.rows()[1]["state"] == "healthy"):
        if sup.rows()[1]["state"] == "failed" or time.monotonic() > deadline:
            fail(f"(a): replica 1 not restarted: {sup.rows()[1]}; events "
                 f"{[e['name'] for e in sup_events.tail(64)]}")
        time.sleep(0.05)
    seq = [s for _, s in states.stop()]
    seq = [s for k, s in enumerate(seq) if k == 0 or s != seq[k - 1]]
    fabric_log = get_event_log()
    died = event_ts(fabric_log, "actor_death", actor=old.actor_id)
    lost_at = [t for t in event_ts(fabric_log, "replica_lost", replica=1)
               if t >= t_wave]
    restarted = event_ts(sup_events, "replica_restarted", replica=1)
    failed = [e for e in sup_events.tail(256)
              if e["name"] in ("replica_restart_failed",
                               "replica_restart_giveup")]
    lost = reg.counter("rlt_serve_failover_requests_total").value(
        outcome="lost") - lost0
    if seq != ["healthy", "dead", "restarting", "healthy"] or failed:
        fail(f"(a): supervisor states {seq}, restart failures {failed}")
    if lost or not died or not lost_at or len(restarted) != 1:
        fail(f"(a): lost {lost}, death {died}, lost verdict {lost_at}, "
             f"restarts {restarted}")
    if sum(h.replica == 1 for h in w["handles"].values()) == 0:
        fail("(a): no request of the wave went to replica 1")
    verdict_s = min(lost_at) - died[0]
    breakdown = startup_breakdown(client, 1)
    # The second wave, pinned to the restarted replica.
    before = replica_counts(client, (1,))
    pinned = [(f"{rid}r", p, sp) for rid, p, sp in wave[:len(wave) // 2]]
    w2 = fleet_wave(client, pinned, replica=1)
    after = replica_counts(client, (1,))
    launches += check_replica_counts("(a) restarted replica", before,
                                     after, cfg, cuda, "serve-recovery")
    near += recovery_compare("(a) restarted replica", pinned, w2["toks"],
                             {f"{rid}r": exact[rid] for rid, _, _ in wave},
                             params, cfg, device)
    if after[1]["compiled_count"] != replica_counts(client, (0,))[0][
            "compiled_count"]:
        fail("(a): the restarted replica's compiled_count differs")
    out = {
        "states": seq,
        "detection_s": verdict_s,
        "kill_to_healthy_s": restarted[0] - died[0],
        "respawn_breakdown_s": breakdown,
        "near_tie_mismatches": near,
        "lost": lost,
        "launches": launches,
    }
    print(f"[serve-recovery] (a) {json.dumps(out)}")
    return out


def recovery_preempt(client, sup, sup_events, wave, exact, params, cfg,
                     device, cuda) -> dict:
    """(b): the ``preempt`` fault on replica 0 with every request of the
    wave pinned to it, its folds slowed so that the drain finds residents
    and a queue; the supervisor drains it (the residents finish in grace,
    the queue migrates), pre-spawns the replacement on fresh capacity
    and swaps it in."""
    from ray_lightning_tpu_torch.obs.events import get_event_log
    from ray_lightning_tpu_torch.obs.registry import get_registry

    reg = get_registry()
    lost0 = reg.counter("rlt_serve_failover_requests_total").value(
        outcome="lost") + reg.counter(
        "rlt_serve_preempt_requests_total").value(outcome="lost")
    old = client._actor(0)
    before = replica_counts(client, (0, 1, 2))
    routable = _Sampler(lambda: len(client.alive_replicas()))
    client.inject_fault(0, [{"point": "fold_boundary", "action": "preempt",
                             "after": 2, "seconds": RECOVERY_GRACE_S}] + [
        {"point": "fold_boundary", "action": "delay",
         "seconds": RECOVERY_DRAIN_DELAY_S, "after": k}
        for k in range(1, 40)])
    pinned = [(f"{rid}p", p, sp) for rid, p, sp in wave]
    w = fleet_wave(client, pinned, replica=0)
    deadline = time.monotonic() + 600
    while not event_ts(sup_events, "replica_preempt_replaced", replica=0):
        if sup.rows()[0]["state"] in ("failed", "dead") or (
                time.monotonic() > deadline):
            fail(f"(b): replica 0 not replaced: {sup.rows()[0]}; events "
                 f"{[e['name'] for e in sup_events.tail(64)]}")
        time.sleep(0.05)
    time.sleep(1.0)
    samples = routable.stop()
    after = replica_counts(client, (1, 2))
    launches = check_replica_counts("(b) survivors", before, after, cfg,
                                    cuda, "serve-recovery")
    near = recovery_compare("(b)", pinned, w["toks"],
                            {f"{rid}p": exact[rid] for rid, _, _ in wave},
                            params, cfg, device)
    (drained,) = [e for e in sup_events.tail(256)
                  if e["name"] == "replica_preempt_drained"]
    notice = event_ts(sup_events, "replica_preempting", replica=0)[0]
    prespawned = event_ts(get_event_log(), "replica_prespawned", replica=0)
    swapped = event_ts(sup_events, "replica_preempt_replaced", replica=0)[0]
    lost = (reg.counter("rlt_serve_failover_requests_total").value(
        outcome="lost") + reg.counter(
        "rlt_serve_preempt_requests_total").value(outcome="lost")) - lost0
    low = min(v for _, v in samples)
    if lost or drained["lost"] or not prespawned or client._actor(0) is old:
        fail(f"(b): lost {lost}, drain {drained}, prespawned {prespawned}")
    if not (drained["finished_in_grace"] and drained["migrated"]):
        fail(f"(b): the drain finished {drained['finished_in_grace']} and "
             f"migrated {drained['migrated']}; both sets must be non-empty")
    if low < 2:
        fail(f"(b): routable replicas fell to {low} in the window")
    if sup.rows()[0]["state"] != "healthy":
        fail(f"(b): supervisor row {sup.rows()[0]}")
    breakdown = startup_breakdown(client, 0)
    # The swapped-in replacement serves.
    before = replica_counts(client, (0,))
    again = [(f"{rid}q", p, sp) for rid, p, sp in wave[:len(wave) // 2]]
    w2 = fleet_wave(client, again, replica=0)
    after = replica_counts(client, (0,))
    launches += check_replica_counts("(b) replacement", before, after,
                                     cfg, cuda, "serve-recovery")
    near += recovery_compare("(b) replacement", again, w2["toks"],
                             {f"{rid}q": exact[rid] for rid, _, _ in wave},
                             params, cfg, device)
    out = {
        "finished_in_grace": drained["finished_in_grace"],
        "migrated": drained["migrated"],
        "kv_blocks": drained["kv_blocks"],
        "routable_min": low,
        "routable_samples": len(samples),
        "notice_to_prespawned_s": prespawned[0] - notice,
        "notice_to_swap_s": swapped - notice,
        "prespawn_breakdown_s": breakdown,
        "near_tie_mismatches": near,
        "lost": lost,
        "launches": launches,
    }
    print(f"[serve-recovery] (b) {json.dumps(out)}")
    return out


def recovery_autoscale(ckpt, wave, exact, params, cfg, device, cuda) -> dict:
    """(c): a one-replica fleet under ``RouterAutoscaler(min_replicas=1,
    max_replicas=2)``, ticked by hand: a burst (the wave pinned to
    nothing, replica 0's folds slowed) scales up through ``add_replica``;
    the added replica serves a pinned wave; an idle fleet scales down
    through ``retire_replica``, and stays at one."""
    from ray_lightning_tpu_torch.obs.events import EventLog
    from ray_lightning_tpu_torch.obs.registry import (
        MetricsRegistry,
        get_registry,
    )
    from ray_lightning_tpu_torch.serve.client import start_replicas
    from ray_lightning_tpu_torch.serve.router import Router, RouterAutoscaler

    reg = get_registry()
    lost0 = reg.counter("rlt_serve_failover_requests_total").value(
        outcome="lost")
    client = start_replicas(
        1, num_gpus_per_replica=RECOVERY_GPUS_C, ckpt_path=ckpt,
        device=device, rpc_timeout_s=120.0, init_timeout=600.0,
        **SERVE_ENGINE)
    try:
        router = Router(client=client, refresh_s=0.0)
        client.router = router
        events = EventLog()
        auto = RouterAutoscaler(
            client, router=router, min_replicas=1, max_replicas=2,
            sustain_ticks=1, down_sustain_ticks=1, up_queue_per_replica=1.0,
            registry=MetricsRegistry(), events=events)
        client.inject_fault(0, [
            {"point": "fold_boundary", "action": "delay",
             "seconds": RECOVERY_BURST_DELAY_S, "after": k}
            for k in range(1, RECOVERY_BURST_FOLDS)])
        before = replica_counts(client, (0,))
        burst = [(f"{rid}c", p, sp) for rid, p, sp in wave]
        scaled = {}

        def tick_up(handles):
            router.refresh(force=True)
            t0 = time.perf_counter()
            scaled["up"] = auto.tick()
            scaled["add_s"] = time.perf_counter() - t0

        # The tick runs once every request is submitted, its streams read.
        w = fleet_wave(client, burst, batch_first_half=False,
                       trigger=(lambda handles, t_first: True, tick_up))
        if scaled["up"]["scaled"] != ("up", 1):
            fail(f"(c): the burst did not scale up: {scaled['up']}")
        client.inject_fault(0, None)
        near = recovery_compare("(c) burst", burst, w["toks"],
                                {f"{rid}c": exact[rid] for rid, _, _ in wave},
                                params, cfg, device)
        mid = replica_counts(client, (0, 1))
        pinned = [(f"{rid}d", p, sp) for rid, p, sp in wave[:len(wave) // 2]]
        w2 = fleet_wave(client, pinned, replica=1)
        after = replica_counts(client, (0, 1))
        launches = check_replica_counts("(c) burst", before, {0: mid[0]},
                                        cfg, cuda, "serve-recovery")
        launches += check_replica_counts("(c) added replica", mid,
                                         {1: after[1]}, cfg, cuda,
                                         "serve-recovery")
        near += recovery_compare("(c) added replica", pinned, w2["toks"],
                                 {f"{rid}d": exact[rid] for rid, _, _ in wave},
                                 params, cfg, device)
        add_breakdown = startup_breakdown(client, 1)
        router.refresh(force=True)
        t0 = time.perf_counter()
        down = auto.tick()
        retire_s = time.perf_counter() - t0
        if down["scaled"] != ("down", 1) or client.alive_replicas() != [0]:
            fail(f"(c): the idle fleet did not scale down: {down}")
        for _ in range(3):
            router.refresh(force=True)
            if auto.tick()["scaled"] is not None:
                fail("(c): scaled below min_replicas")
        lost = reg.counter("rlt_serve_failover_requests_total").value(
            outcome="lost") - lost0
        if lost:
            fail(f"(c): {lost} requests lost")
        out = {
            "scaled": [scaled["up"]["scaled"], down["scaled"]],
            "queue_depth_at_up": scaled["up"]["queue_depth"],
            "add_s": scaled["add_s"],
            "retire_s": retire_s,
            "added_breakdown_s": add_breakdown,
            "events": [e["name"] for e in events.tail(16)],
            "near_tie_mismatches": near,
            "lost": lost,
            "launches": launches,
        }
        print(f"[serve-recovery] (c) {json.dumps(out)}")
        return out
    finally:
        client.shutdown()


def remote_child(address: str, key: str, ckpt: str, out_path: str,
                 vocab: int, device: str) -> None:
    """(d)'s client process: connect to the head in client mode, start one
    replica there through ``start_replicas``, serve serve-fleet's wave 1,
    write the tokens and the replica's counts to ``out_path`` (JSON), shut
    the fleet down and disconnect. Runs as ``python -c`` in a
    process of its own; it never touches the card itself."""
    from ray_lightning_tpu_torch import fabric
    from ray_lightning_tpu_torch.serve.client import start_replicas

    import numpy as np

    fabric.init(address=address, authkey=key)
    try:
        wave = fleet_wave1(vocab)
        t0 = time.time()
        client = start_replicas(
            1, num_gpus_per_replica=RECOVERY_GPUS_C, ckpt_path=ckpt,
            device=device, rpc_timeout_s=120.0, init_timeout=600.0,
            **SERVE_ENGINE)
        try:
            spawn_s = time.time() - t0
            before = replica_counts(client, (0,))[0]
            w = fleet_wave(client, wave)
            after = replica_counts(client, (0,))[0]
            cards = client._actor(0).visible_cards
        finally:
            client.shutdown()
        with open(out_path, "w") as f:
            json.dump({"toks": w["toks"], "before": before, "after": after,
                       "spawn_s": spawn_s, "cards": cards,
                       "wall_s": w["wall"],
                       "n_tok": int(np.sum([len(t) for t in
                                            w["toks"].values()]))}, f)
    finally:
        fabric.shutdown()


def fleet_wave1(vocab: int) -> list:
    """serve-fleet (a)'s wave 1: the serve phase's 8 requests, then the
    same 8 with seeds raised by 100."""
    import dataclasses

    import numpy as np

    reqs = serve_workload(vocab, np.random.default_rng(0))
    return reqs + [(f"{rid}n", p, dataclasses.replace(sp, seed=sp.seed + 100))
                   for rid, p, sp in reqs]


def descendants(pid: int) -> set:
    """Every live descendant of ``pid`` (``/proc``)."""
    kids = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z":
            kids.setdefault(int(fields[1]), []).append(int(d))
    out, todo = set(), [pid]
    while todo:
        for k in kids.get(todo.pop(), []):
            if k not in out:
                out.add(k)
                todo.append(k)
    return out


class RemoteFabric:
    """(d): a head (``python -m ray_lightning_tpu_torch.fabric.server
    --port 0``) and a client process running :func:`remote_child` against
    it, started together and run beside (c). ``finish()`` waits for the
    child, stops the head with SIGINT (its fabric session's exit hook
    kills its actors) and returns the child's record and every process
    the two had started that is still alive."""

    def __init__(self, ckpt: str, workdir: str, vocab: int, device: str):
        import queue
        import threading

        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [HERE, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
        self.t0 = time.perf_counter()
        self.head = subprocess.Popen(
            [sys.executable, "-m", "ray_lightning_tpu_torch.fabric.server",
             "--port", "0"], cwd=HERE, env=env, stdout=subprocess.PIPE,
            text=True)
        lines = queue.Queue()
        self.head_lines = []

        def drain():
            for line in self.head.stdout:
                self.head_lines.append(line)
                lines.put(line)

        threading.Thread(target=drain, daemon=True).start()
        deadline = time.monotonic() + 120
        ready = None
        while ready is None:
            if self.head.poll() is not None or time.monotonic() > deadline:
                fail(f"(d): the head never became ready: {self.head_lines}")
            try:
                line = lines.get(timeout=0.5)
            except queue.Empty:
                continue
            if line.startswith("FABRIC_SERVER_READY"):
                ready = line.split()
        address = ready[1]
        key = next(p[4:] for p in ready[2:] if p.startswith("key="))
        self.head_ready_s = time.perf_counter() - self.t0
        self.out_path = os.path.join(workdir, "remote.json")
        code = ("import sys; sys.path.insert(0, {here!r}); import chip_smoke;"
                " chip_smoke.remote_child({a!r}, {k!r}, {c!r}, {o!r}, {v!r},"
                " {d!r})").format(here=HERE, a=address, k=key, c=ckpt,
                                  o=self.out_path, v=vocab, d=device)
        self.child = subprocess.Popen([sys.executable, "-c", code], cwd=HERE,
                                      env=env)

    def finish(self) -> tuple:
        import signal

        try:
            rc = self.child.wait(timeout=900)
        except subprocess.TimeoutExpired:
            self.child.kill()
            fail("(d): the client process did not finish")
        tree = descendants(self.head.pid)
        self.head.send_signal(signal.SIGINT)
        try:
            self.head.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.head.kill()
            fail("(d): the head did not stop on SIGINT")
        if rc != 0:
            fail(f"(d): the client process exited {rc}")
        with open(self.out_path) as f:
            rec = json.load(f)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and any(
                os.path.exists(f"/proc/{p}") for p in tree):
            time.sleep(0.5)
        left = {p for p in tree | {self.head.pid, self.child.pid}
                if os.path.exists(f"/proc/{p}")}
        rec["wall_s_total"] = time.perf_counter() - self.t0
        rec["head_ready_s"] = self.head_ready_s
        return rec, left


def serve_recovery_run(params, cfg, device, ckpt: str, workdir: str,
                       engine) -> dict:
    """The serve-recovery traffic (see ``phase_serve_recovery``) on
    ``device``. ``engine`` is the serve phase's in-process engine on the
    same weights, the yardstick of every token. On the CPU (a rehearsal
    at a tiny width) set ``RLT_NUM_GPUS`` so the fabric has a card to
    share out; the launch gates then check nothing."""
    import torch

    from ray_lightning_tpu_torch import fabric
    from ray_lightning_tpu_torch.obs.events import EventLog
    from ray_lightning_tpu_torch.obs.registry import MetricsRegistry
    from ray_lightning_tpu_torch.serve.client import start_replicas
    from ray_lightning_tpu_torch.serve.supervisor import FleetSupervisor

    cuda = torch.device(device).type == "cuda"
    wave = fleet_wave1(cfg.vocab_size)
    exact = serve_run(engine, wave)["toks"]
    out = {}
    fabric.init()
    try:
        t0 = time.perf_counter()
        client = start_replicas(
            3, num_gpus_per_replica=RECOVERY_GPUS_A, ckpt_path=ckpt,
            device=device, rpc_timeout_s=120.0, init_timeout=600.0,
            **SERVE_ENGINE)
        out["spawn_s_fleet_a"] = time.perf_counter() - t0
        out["initial_breakdown_s"] = startup_breakdown(client, 0)
        print(f"[serve-recovery] fleet A up in {out['spawn_s_fleet_a']:.1f} s"
              f" on cards {[client._actor(i).visible_cards for i in range(3)]}"
              f"; replica 0's start-up {json.dumps(out['initial_breakdown_s'])}")
        sup_events = EventLog()
        sup = FleetSupervisor(
            client, interval_s=RECOVERY_TICK_S,
            restart_backoff_s=RECOVERY_BACKOFF_S, restart_limit=2,
            probe_timeout_s=120.0, registry=MetricsRegistry(),
            events=sup_events).start()
        try:
            out["crash"] = recovery_crash(client, sup, sup_events, wave,
                                          exact, params, cfg, device, cuda)
            out["preempt"] = recovery_preempt(client, sup, sup_events, wave,
                                              exact, params, cfg, device,
                                              cuda)
        finally:
            sup.stop()
            client.shutdown()
        remote = RemoteFabric(ckpt, workdir, cfg.vocab_size, str(device))
        try:
            out["autoscale"] = recovery_autoscale(ckpt, wave, exact, params,
                                                  cfg, device, cuda)
        finally:
            rec, left = remote.finish()
        if left:
            fail(f"(d): processes left after the head stopped: {left}")
        near = recovery_compare("(d)", wave, rec["toks"], exact, params,
                                cfg, device)
        launches = check_replica_counts(
            "(d) remote replica", {0: rec["before"]}, {0: rec["after"]}, cfg,
            cuda, "serve-recovery")
        out["remote"] = {
            "head_ready_s": rec["head_ready_s"], "spawn_s": rec["spawn_s"],
            "wall_s": rec["wall_s"], "total_s": rec["wall_s_total"],
            "tokens_per_s": rec["n_tok"] / rec["wall_s"],
            "cards": rec["cards"], "near_tie_mismatches": near,
            "launches": launches,
        }
        print(f"[serve-recovery] (d) {json.dumps(out['remote'])}")
    finally:
        fabric.shutdown()
    out["launches"] = sum(out[k]["launches"] for k in
                          ("crash", "preempt", "autoscale", "remote"))
    return out


def phase_serve_recovery(serve4: dict, fleet: dict) -> int:
    """The fleet's recovery plane at GPT-2-small width and depth on
    serve-fleet's checkpoint, ``RLT_REQUIRE_GPU=1`` (``serve_recovery_run``):
    (a) a replica of a three-replica fleet killed by a fault at a fold
    boundary mid-wave, a ``FleetSupervisor`` restarting it; (b) the
    ``preempt`` fault on another, drained, its replacement pre-spawned and
    swapped in; (c) ``RouterAutoscaler(min_replicas=1, max_replicas=2)``
    ticked by hand: a burst adds a replica, an idle fleet retires it;
    (d) a fabric head in a subprocess and a client process that starts a
    replica through client mode and serves serve-fleet's wave 1.

    Card shares: fleet A's three replicas a quarter each, since (b)'s
    replacement is spawned outside A's placement group while the dying
    replica still holds its quarter (the fabric's card accounting, not
    the card's memory, limits the fleet); with three, two stay routable
    through (b)'s grace window. Fleet C's replicas and (d)'s a third each.
    The serve phase's engine is monolithic: it has no prefix pool, so
    (b)'s migrated requests (the queued ones) carry no KV blocks and are
    prefilled again on the survivors; the KV-carrying migration is held
    on the CPU (``tests/test_torch_recovery.py``).

    Gates: 0 requests lost in every section; every token bitwise the
    serve phase's in-process engine's on the same requests (near-ties
    aside, serve-fleet's rule); (a) the supervisor's states healthy ->
    dead -> restarting -> healthy with one restart and no failed attempt,
    the restarted replica serving a pinned wave bitwise; (b) both the
    finish and the migrate sets non-empty, the routable count sampled
    every 10 ms never below 2, the replacement serving a pinned wave; (c)
    one scale up, one scale down, none below the minimum, the added
    replica serving a pinned wave; (d) tokens bitwise, no process of the
    head or the client left after the head stops; every replica's graphs
    frozen and 12 K1 launches per admission (its ``stats()``); the card's
    memory back within FLEET_MEM_SLACK_MIB and no child left. Prints each
    section's seconds (detection, kill to healthy, notice to swap, add,
    retire), the respawned, pre-spawned and added replicas' start-up
    breakdowns. Removes serve-fleet's checkpoint. Returns K1's launches
    inside the replicas."""
    os.environ["RLT_REQUIRE_GPU"] = "1"
    kids0 = child_pids()
    mem0 = card_memory_mib()
    try:
        out = serve_recovery_run(fleet["params"], fleet["cfg"], "cuda",
                                 fleet["ckpt"], fleet["workdir"],
                                 serve4["sched"].engine)
    finally:
        shutil.rmtree(fleet["workdir"], ignore_errors=True)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and (
            set(child_pids()) - set(kids0)
            or card_memory_mib() > mem0 + FLEET_MEM_SLACK_MIB):
        time.sleep(0.5)
    kids, mem = set(child_pids()) - set(kids0), card_memory_mib()
    print(f"[serve-recovery] after shutdown: children {sorted(kids)}, card "
          f"memory {mem} MiB (before the phase {mem0} MiB)")
    if kids:
        fail(f"child processes left after shutdown: {sorted(kids)}")
    if mem > mem0 + FLEET_MEM_SLACK_MIB:
        fail(f"card memory {mem} MiB after the phase, {mem0} MiB before")
    summary = {
        "detection_s": out["crash"]["detection_s"],
        "kill_to_healthy_s": out["crash"]["kill_to_healthy_s"],
        "respawn_breakdown_s": out["crash"]["respawn_breakdown_s"],
        "preempt_notice_to_swap_s": out["preempt"]["notice_to_swap_s"],
        "preempt_routable_min": out["preempt"]["routable_min"],
        "autoscale_add_s": out["autoscale"]["add_s"],
        "autoscale_retire_s": out["autoscale"]["retire_s"],
        "remote_spawn_s": out["remote"]["spawn_s"],
        "launches": out["launches"],
        "card_mib": [mem0, mem],
    }
    print(f"[serve-recovery] {json.dumps(summary)} on {card_line()}")
    return out["launches"]


def phase_train(n_steps: int = 20):
    """GPT-2 small at full width and depth through ``Trainer.fit``: bf16
    compute over fp32 master weights, flash attention forward (K1) and
    backward (K2, K3), dense ``lm_loss``, AdamW with warmup. Step times are
    host time between consecutive step ends (each step's loss is read on
    the host, a device sync)."""
    import shutil
    import statistics

    import torch

    from ray_lightning_tpu_torch.models.gpt import GPTLM, GPTConfig
    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.trainer import Callback, Trainer
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    class StepClock(Callback):
        def __init__(self):
            self.ends, self.losses = [], []

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            self.ends.append(time.perf_counter())
            self.losses.append(logs["loss"])

    cfg = GPTConfig.gpt2_small()
    batch = 8
    # Two batches per epoch: every sequence comes back every other step,
    # so 20 steps lower the loss well clear of its step-to-step noise (on
    # fresh rows of this corpus it hardly moves from ln(V) in 20 steps).
    # Validation (2 batches) and the default checkpoint run every 5
    # epochs.
    module = GPTLM(cfg, batch_size=batch, warmup_steps=2, n_train=2 * batch)
    clock = StepClock()
    root = os.path.join(HERE, "build", "smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    trainer = Trainer(
        max_epochs=n_steps // 2, max_steps=n_steps, limit_val_batches=2,
        check_val_every_n_epoch=5,
        seed=0, log_every_n_steps=1, callbacks=[clock], default_root_dir=root,
    )
    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.fit(module)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        "flash_fwd": counters.launches,
        "flash_bwd_dkv": counters.bwd_dkv_launches,
        "flash_bwd_dq": counters.bwd_dq_launches,
        "reference": counters.reference,
    }
    shutil.rmtree(root, ignore_errors=True)
    losses = clock.losses
    print(f"[train] {n_steps} steps of GPT-2 small (B={batch}, S="
          f"{cfg.max_seq}, bf16 compute, flash attention) through "
          f"Trainer.fit in {wall:.3f} s; launches {json.dumps(launches)}")
    print(f"[train] losses {losses}")
    if len(losses) != n_steps or trainer.global_step != n_steps:
        fail(f"trained {trainer.global_step} steps, {len(losses)} losses, "
             f"expected {n_steps}")
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite training loss")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: first {losses[0]}, last {losses[-1]}")
    expect = cfg.n_layer * n_steps
    if (launches["flash_bwd_dkv"] != expect
            or launches["flash_bwd_dq"] != expect
            or launches["reference"] != 0):
        fail(f"backward kernel launches {launches} != {expect} each (12 "
             f"layers x {n_steps} steps) with 0 reference-path calls")
    if launches["flash_fwd"] < expect:
        fail(f"flash_fwd launched {launches['flash_fwd']} < {expect} times")
    steps_s = [b - a for a, b in zip(clock.ends, clock.ends[1:])]
    # Steps 4.. (after the first 3); the median steps over the two that
    # also hold an epoch-end validation and checkpoint.
    step_s = statistics.median(steps_s[2:])
    tokens = batch * cfg.max_seq
    n_params = sum(int(x.numel()) for x in tree_leaves(module.params))
    # The JAX package's FLOPs per token (obs/telemetry.py:133): 6N + 12*L*D*S.
    fpt = 6.0 * n_params + 12.0 * cfg.n_layer * cfg.d_model * cfg.max_seq
    train = {
        "steps": n_steps,
        "step_ms_median": step_s * 1e3,
        "step_ms_all": [x * 1e3 for x in steps_s],
        "tokens_per_s": tokens / step_s,
        "mfu": fpt * tokens / step_s / PEAK_FLOPS["bfloat16"],
        "n_params": n_params,
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "val_loss": trainer.callback_metrics.get("val_loss"),
        "wall_s": wall,
    }
    train["steps_per_execution"] = train_folded(n_steps)
    print(f"[train] {json.dumps(train)} on {card_line()}")
    # The yardstick of train-dist (a): this fit's per-step losses, final
    # parameters (CPU copies) and launches.
    yard = {"losses": losses, "launches": launches,
            "step_ms": step_s * 1e3, "val_loss": train["val_loss"],
            "params": {k: (v.detach().cpu().clone() if torch.is_tensor(v)
                           else {n: t.detach().cpu().clone()
                                 for n, t in v.items()})
                       for k, v in module.params.items()}}
    return launches, train, yard


def train_folded(n_steps: int, fold: int = 4) -> dict:
    """The same model and data with 4 batches per epoch and no validation,
    ``n_steps`` steps one per dispatch and then ``fold`` per dispatch (one
    CUDA graph of ``fold`` steps): each folded loss must equal the
    single-step run's at the same step within 1e-3 relative, with the same
    kernel launches. Returns both step times."""
    import torch

    from ray_lightning_tpu_torch.models.gpt import GPTLM, GPTConfig
    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.trainer import Callback, Trainer

    class StepClock(Callback):
        def __init__(self):
            self.ends, self.losses = [], []

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            self.ends.append(time.perf_counter())
            self.losses.append(logs["loss"])

    runs = {}
    for k in (1, fold):
        clock = StepClock()
        trainer = Trainer(
            max_steps=n_steps, max_epochs=n_steps, limit_val_batches=0,
            enable_checkpointing=False, enable_model_summary=False, seed=0,
            log_every_n_steps=1, callbacks=[clock], steps_per_execution=k,
        )
        counters.reset()
        trainer.fit(GPTLM(GPTConfig.gpt2_small(), batch_size=8,
                          warmup_steps=2, n_train=4 * 8))
        torch.cuda.synchronize()
        per = [(b - a) / k for a, b in zip(clock.ends, clock.ends[1:])]
        runs[k] = {"losses": clock.losses, "step_ms": [1e3 * x for x in per],
                   "launches": (counters.launches, counters.bwd_dkv_launches,
                                counters.bwd_dq_launches),
                   "graphs": [p.compiled_count for p in
                              dict.fromkeys(trainer.train_programs)]}
    one, many = runs[1], runs[fold]
    want = one["losses"][fold - 1 :: fold]
    worst = max(abs(a - b) / abs(b) for a, b in zip(many["losses"], want))
    print(f"[train] steps_per_execution={fold}: losses {many['losses']}, "
          f"single-step losses at the same steps {want}, worst relative "
          f"difference {worst}, launches {many['launches']} vs "
          f"{one['launches']}, graphs {many['graphs']} vs {one['graphs']}")
    if len(many["losses"]) != n_steps // fold or worst > 1e-3:
        fail(f"steps_per_execution={fold}: losses {many['losses']} vs {want}")
    if many["launches"] != one["launches"]:
        fail(f"steps_per_execution={fold}: kernel launches "
             f"{many['launches']} != the single-step run's {one['launches']}")
    return {"fold": fold, "worst_rel_loss_diff": worst,
            "bitwise": many["losses"] == want,
            "step_ms_median": statistics_median(many["step_ms"][1:]),
            "step_ms_median_single": statistics_median(one["step_ms"][2:]),
            "graphs": many["graphs"]}


DIST_ROOT = os.path.join(HERE, "build", "smoke_train_dist")
#: (b)'s fits and their steps: each held bitwise against (a)'s first 6.
DIST_B_STEPS = 6
#: (c): two ranks sharing the card, fp32, 4 layers, 10 steps.
DIST_C = dict(n_layer=4, batch=4, steps=10)


def dist_probe(tag: str, digest_at: int = 0):
    """A callback of this script for launched fits: in each worker it
    zeroes the kernel counters as the fit starts, records every step's
    loss, end time and graph count, and at the fit's end writes one JSON
    per rank under ``build/smoke_train_dist/`` (the launches, the graphs,
    the group's backend, the card it ran on, peak memory). With
    ``digest_at`` it also records a SHA-256 of the parameters after that
    step."""
    from ray_lightning_tpu_torch.trainer import Callback

    class DistProbe(Callback):
        def __init__(self):
            self.tag, self.digest_at = tag, digest_at

        def on_fit_start(self, trainer, module):
            import torch

            from ray_lightning_tpu_torch.ops.flash_attention import counters

            counters.reset()
            timer = getattr(torch.distributed, "_smoke_collective_s", None)
            if timer is not None:
                timer[:] = [0.0, 0]
            self.collective = []
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
            self.ends, self.losses, self.graphs = [], [], []
            self.digest, self.at_rest = None, 0

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            import torch

            self.ends.append(time.perf_counter())
            self.losses.append(logs["loss"])
            self.graphs.append(sum(p.compiled_count for p in
                                   dict.fromkeys(trainer.train_programs)))
            timer = getattr(torch.distributed, "_smoke_collective_s", None)
            if timer is not None:
                # (seconds, calls) inside collectives up to this step's end.
                self.collective.append(list(timer))
            if self.digest_at and trainer.global_step == self.digest_at:
                self.digest = params_digest(trainer.params)
            if torch.cuda.is_available():
                # Between steps: what the fit holds at rest.
                self.at_rest = torch.cuda.memory_allocated()

        def on_fit_end(self, trainer, module):
            import dataclasses

            import torch

            from ray_lightning_tpu_torch.ops.flash_attention import counters

            strat = trainer.strategy
            cuda = torch.cuda.is_available()
            blocks = trainer.params["blocks"]
            rec = {
                "local_shapes": {
                    "wqkv": list(blocks["wqkv"].shape),
                    "wi": list(blocks["wi"].shape),
                    "wte": list(trainer.params["wte"].shape)},
                "collective_s": self.collective,
                "rank": trainer.global_rank, "world": trainer.world_size,
                "backend": strat.dist_env.backend,
                "graphed": bool(trainer.train_programs[0].capture),
                "launches": {"flash_fwd": counters.launches,
                             "flash_bwd_dkv": counters.bwd_dkv_launches,
                             "flash_bwd_dq": counters.bwd_dq_launches,
                             "reference": counters.reference},
                "losses": self.losses, "ends": self.ends,
                "graphs": self.graphs, "digest": self.digest,
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "card": (str(torch.cuda.get_device_properties(0).uuid)
                         if cuda else None),
                "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                                 if cuda else 0.0),
                "at_rest_mib": self.at_rest / 2**20,
                "reserved_gib": (torch.cuda.memory_reserved() / 2**30
                                 if cuda else 0.0),
                # ZeRO-3's per-layer traffic (counted at a graph's capture
                # on NCCL; every step on gloo, with its seconds).
                "gather_stats": (dataclasses.asdict(trainer.optimizer
                                                    .gather_stats)
                                 if getattr(trainer.optimizer,
                                            "gather_stats", None)
                                 else None),
            }
            os.makedirs(DIST_ROOT, exist_ok=True)
            path = os.path.join(DIST_ROOT,
                                f"{self.tag}-rank{trainer.global_rank}.json")
            with open(path, "w") as f:
                json.dump(rec, f)

    return DistProbe()


def params_digest(params) -> str:
    """SHA-256 of a parameter tree's bytes, leaf by leaf in tree order."""
    import hashlib

    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(leaf.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def read_probe(tag: str, world: int) -> list:
    out = []
    for r in range(world):
        with open(os.path.join(DIST_ROOT, f"{tag}-rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def params_max_diff(a, b) -> float:
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def params_equal(a, b) -> bool:
    import torch

    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def dist_fit(tag: str, strategy, module, root: str, n_steps: int,
             digest_at: int = 0, callbacks=(), **kw) -> dict:
    """One launched fit of ``module`` for ``n_steps`` steps through
    ``Trainer.fit`` and the launcher; returns the driver's trainer and the
    ranks' probe records, with the actors' spawn seconds (the fabric's
    ``actor_start`` events) and the fit's wall."""
    from ray_lightning_tpu_torch.trainer import Trainer

    shutil.rmtree(root, ignore_errors=True)
    for name in os.listdir(DIST_ROOT) if os.path.isdir(DIST_ROOT) else ():
        if name.startswith(tag + "-"):
            os.remove(os.path.join(DIST_ROOT, name))
    trainer = Trainer(strategy=strategy, max_steps=n_steps, seed=0,
                      log_every_n_steps=1, default_root_dir=root,
                      callbacks=[dist_probe(tag, digest_at), *callbacks], **kw)
    t_wall, t0 = time.time(), time.perf_counter()
    trainer.fit(module)
    wall = time.perf_counter() - t0
    ranks = read_probe(tag, strategy.num_workers)
    return {"trainer": trainer, "ranks": ranks, "wall_s": wall,
            "spawn_s": workers_ready_seconds(t_wall)}


def workers_ready_seconds(t0: float) -> float:
    """Seconds the launcher took from spawning a fit's actors (together)
    until every one answered: its ``workers_ready`` event after ``t0``."""
    from ray_lightning_tpu_torch.obs.events import get_event_log

    ready = [e for e in get_event_log().tail(64, subsystem="launcher",
                                             name="workers_ready")
             if e["ts"] >= t0]
    if not ready:
        fail("train-dist: the launcher recorded no workers_ready event")
    return ready[-1]["seconds"]


def dist_summary(tag: str, run: dict, tokens_per_step: int) -> dict:
    """What the phase prints of one launched fit: backend, graphs, step
    time (median of steps 3 to the end), tokens/s and peak memory per
    rank, spawn seconds."""
    ranks = run["ranks"]
    steps = [b - a for a, b in zip(ranks[0]["ends"], ranks[0]["ends"][1:])]
    step_ms = statistics_median(steps[2:]) * 1e3
    return {"fit": tag, "world": ranks[0]["world"],
            "backend": ranks[0]["backend"], "graphed": ranks[0]["graphed"],
            "graphs": ranks[0]["graphs"][-1], "step_ms_median": step_ms,
            "tokens_per_s": tokens_per_step / step_ms * 1e3,
            "tokens_per_s_per_rank": tokens_per_step / step_ms * 1e3
            / len(ranks),
            "peak_mem_gib_per_rank": [r["peak_mem_gib"] for r in ranks],
            "at_rest_mib_per_rank": [r["at_rest_mib"] for r in ranks],
            "reserved_gib_per_rank": [r["reserved_gib"] for r in ranks],
            "spawn_s": run["spawn_s"], "wall_s": run["wall_s"],
            "launches_rank0": ranks[0]["launches"]}


def check_dist_kernels(tag: str, ranks: list, n_steps: int, n_layer: int,
                       fwd_want=None) -> None:
    """Each rank ran K2 and K3 once per layer per step, K1 at least that
    often (``fwd_want`` exactly, when given) and the reference path
    never."""
    expect = n_layer * n_steps
    for r in ranks:
        got = r["launches"]
        if (got["flash_bwd_dkv"] != expect or got["flash_bwd_dq"] != expect
                or got["reference"] != 0 or got["flash_fwd"] < expect
                or (fwd_want is not None and got["flash_fwd"] != fwd_want)):
            fail(f"train-dist {tag} rank {r['rank']}: launches {got}, "
                 f"expected {expect} of each backward kernel, flash_fwd "
                 f"{fwd_want if fwd_want is not None else f'>= {expect}'} "
                 "and 0 reference-path calls")


def phase_train_dist(yard: dict):
    """train-dist: the launched trainer on fabric actors. (a) The train
    phase's fit through ``RayStrategy(num_workers=1)`` (NCCL, graphs),
    bitwise phase 14's; (b) ``HorovodRayStrategy`` and
    ``RayShardedStrategy`` stages 1 and 3 for 6 steps, bitwise (a)'s
    first 6; (c) two ranks sharing the card (gloo, eager, fp32, 4 layers)
    against an in-process fit of the same global batch. Returns each
    kernel's launches on the phase's fits."""
    import gc
    import logging

    import torch

    from ray_lightning_tpu_torch import fabric
    from ray_lightning_tpu_torch.models.gpt import GPTLM, GPTConfig
    from ray_lightning_tpu_torch.strategies import (
        HorovodRayStrategy,
        RayShardedStrategy,
        RayStrategy,
    )
    from ray_lightning_tpu_torch.trainer import Trainer
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    cfg = GPTConfig.gpt2_small()
    batch, n_steps = 8, len(yard["losses"])
    tokens = batch * cfg.max_seq

    def gpt2(**kw):
        return GPTLM(cfg, batch_size=batch, warmup_steps=2,
                     n_train=2 * batch, **kw)

    # (c)'s yardstick first, in this process, so that its memory is
    # returned before the card's memory is read.
    c_cfg = GPTConfig.gpt2_small(n_layer=DIST_C["n_layer"],
                                 compute_dtype="float32")
    c_kw = dict(max_steps=DIST_C["steps"], max_epochs=DIST_C["steps"],
                precision="fp32", seed=0, log_every_n_steps=1,
                limit_val_batches=0, num_sanity_val_steps=0,
                enable_checkpointing=False, enable_model_summary=False)

    from ray_lightning_tpu_torch.trainer import Callback

    class Losses(Callback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            self.losses.append(logs["loss"])

    c_losses = Losses()
    c_mod = GPTLM(c_cfg, batch_size=2 * DIST_C["batch"], warmup_steps=2,
                  n_train=4 * DIST_C["batch"])
    Trainer(callbacks=[c_losses], **c_kw).fit(c_mod)
    c_yard = {"losses": c_losses.losses,
              "params": {k: (v.cpu() if torch.is_tensor(v)
                             else {n: t.cpu() for n, t in v.items()})
                         for k, v in c_mod.params.items()}}
    del c_mod
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem_before = card_memory_mib()
    kids_before = child_pids()

    warned = []

    class Seen(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    handler = Seen(level=logging.WARNING)
    logging.getLogger("ray_lightning_tpu_torch").addHandler(handler)
    summaries, launches = [], {"flash_fwd": 0, "flash_bwd_dkv": 0,
                               "flash_bwd_dq": 0}

    def tally(ranks):
        for r in ranks:
            for k in launches:
                launches[k] += r["launches"][k]

    try:
        # (a) the train phase's fit, one whole-card worker.
        root = os.path.join(DIST_ROOT, "a")
        module = gpt2()
        a = dist_fit("a", RayStrategy(num_workers=1), module, root, n_steps,
                     digest_at=DIST_B_STEPS, max_epochs=n_steps // 2,
                     limit_val_batches=2, check_val_every_n_epoch=5)
        (r,) = a["ranks"]
        tally(a["ranks"])
        # train-gspmd (a) is held against this digest after 6 steps.
        yard["digest"] = r["digest"]
        best = a["trainer"].checkpoint_callback.best_model_path
        same_params = params_equal(module.params, yard["params"])
        print(f"[train-dist] (a) RayStrategy(num_workers=1): losses "
              f"{r['losses']}; bitwise the train phase's: losses "
              f"{r['losses'] == yard['losses']}, params {same_params}; "
              f"graphs per step {r['graphs']}; checkpoint {best}")
        if r["losses"] != yard["losses"]:
            worst = max(abs(x - y) / abs(y)
                        for x, y in zip(r["losses"], yard["losses"]))
            fail(f"train-dist (a): losses differ from the train phase's "
                 f"(worst relative {worst}): {r['losses']} vs "
                 f"{yard['losses']}")
        if not same_params:
            fail(f"train-dist (a): final params differ from the train "
                 f"phase's by {params_max_diff(module.params, yard['params'])}")
        check_dist_kernels("(a)", a["ranks"], n_steps, cfg.n_layer,
                           fwd_want=yard["launches"]["flash_fwd"])
        if (r["backend"] != "nccl" or not r["graphed"] or r["graphs"][0] < 1
                or len(set(r["graphs"])) != 1):
            fail(f"train-dist (a): backend {r['backend']}, graphed "
                 f"{r['graphed']}, graphs per step {r['graphs']}: expected "
                 "nccl, graphed, frozen after the first step")
        if (not best or not best.startswith(root) or not os.path.exists(best)
                or a["trainer"].global_step != n_steps):
            fail(f"train-dist (a): checkpoint {best!r} not recovered in the "
                 f"driver, or {a['trainer'].global_step} steps")
        summaries.append(dist_summary("a", a, tokens))
        del module, a
        shutil.rmtree(root, ignore_errors=True)

        # (b) the other strategies, 6 steps each, bitwise (a)'s first 6.
        at_rest = {}
        param_mib = sum(t.numel() * 4 for t in tree_leaves(
            yard["params"])) / 2**20
        for tag, strat in (
            ("b-horovod", HorovodRayStrategy(num_workers=1)),
            ("b-zero1", RayShardedStrategy(num_workers=1, zero_stage=1)),
            ("b-zero3", RayShardedStrategy(num_workers=1, zero_stage=3)),
        ):
            root = os.path.join(DIST_ROOT, tag)
            module = gpt2()
            b = dist_fit(tag, strat, module, root, DIST_B_STEPS,
                         max_epochs=DIST_B_STEPS // 2, limit_val_batches=2,
                         check_val_every_n_epoch=5)
            (rb,) = b["ranks"]
            tally(b["ranks"])
            digest = params_digest(module.params)
            print(f"[train-dist] ({tag}) losses {rb['losses']}; bitwise "
                  f"(a)'s first {DIST_B_STEPS}: losses "
                  f"{rb['losses'] == r['losses'][:DIST_B_STEPS]}, params "
                  f"{digest == r['digest']}; graphs {rb['graphs']}; "
                  f"per-layer gathers (captured) {rb['gather_stats']}")
            if tag == "b-zero3" and not (rb["gather_stats"] or {}).get(
                    "gathers"):
                fail(f"train-dist (b-zero3): no per-layer gather in the "
                     f"step: {rb['gather_stats']}")
            if rb["losses"] != r["losses"][:DIST_B_STEPS]:
                fail(f"train-dist ({tag}): losses {rb['losses']} differ from "
                     f"(a)'s first {DIST_B_STEPS} {r['losses'][:DIST_B_STEPS]}")
            if digest != r["digest"]:
                fail(f"train-dist ({tag}): final params differ from (a)'s "
                     f"after {DIST_B_STEPS} steps (SHA-256)")
            check_dist_kernels(f"({tag})", b["ranks"], DIST_B_STEPS,
                               cfg.n_layer)
            if (rb["backend"] != "nccl" or not rb["graphed"]
                    or len(set(rb["graphs"])) != 1):
                fail(f"train-dist ({tag}): backend {rb['backend']}, graphed "
                     f"{rb['graphed']}, graphs per step {rb['graphs']}")
            summaries.append(dist_summary(tag, b, tokens))
            at_rest[tag] = rb["at_rest_mib"]
            del module, b
            shutil.rmtree(root, ignore_errors=True)
        # ZeRO-3 holds its slices of the fp32 leaves between steps and not
        # the leaves: at world 1, one copy of the parameters less.
        cut = at_rest["b-zero1"] - at_rest["b-zero3"]
        print(f"[train-dist] between steps: zero1 {at_rest['b-zero1']} MiB, "
              f"zero3 {at_rest['b-zero3']} MiB allocated; the fp32 "
              f"parameters are {param_mib} MiB")
        if cut < 0.9 * param_mib:
            fail(f"train-dist (b-zero3): {at_rest['b-zero3']} MiB allocated "
                 f"between steps, {cut} MiB below zero1's: expected the "
                 f"{param_mib} MiB of full fp32 leaves freed")

        # (c) two ranks on the one card: gloo, eager, fp32.
        root = os.path.join(DIST_ROOT, "c")
        module = GPTLM(c_cfg, batch_size=DIST_C["batch"], warmup_steps=2,
                       n_train=4 * DIST_C["batch"])
        n_warned = len(warned)
        c = dist_fit("c", RayStrategy(num_workers=2,
                                      resources_per_worker={"GPU": 0.5}),
                     module, root, DIST_C["steps"],
                     **{k: v for k, v in c_kw.items()
                        if k not in ("max_steps", "seed", "log_every_n_steps")})
        tally(c["ranks"])
        got = c["ranks"][0]["losses"]
        worst = max(abs(x - y) / abs(y) for x, y in zip(got, c_yard["losses"]))
        pdiff = params_max_diff(module.params, c_yard["params"])
        seen = warned[n_warned:]
        frac = any("fractional GPU" in m for m in seen)
        eager = any("eagerly" in m for m in seen)
        cards = {rc["card"] for rc in c["ranks"]}
        print(f"[train-dist] (c) 2 ranks at GPU=0.5: losses {got} vs the "
              f"in-process fit's {c_yard['losses']}: worst relative "
              f"{worst}; params max abs diff {pdiff}; cards {sorted(cards)}; "
              f"fractional warning {frac}, eager warning {eager}")
        if len(got) != DIST_C["steps"] or worst > 1e-4:
            fail(f"train-dist (c): losses {got} vs {c_yard['losses']} "
                 f"(worst relative {worst} > 1e-4)")
        if pdiff > 1e-4:
            fail(f"train-dist (c): final params differ by {pdiff} > 1e-4")
        if len(cards) != 1 or None in cards:
            fail(f"train-dist (c): ranks ran on cards {cards}, expected one")
        if not (frac and eager):
            fail(f"train-dist (c): warnings seen {seen}: expected the "
                 "fractional-GPU and the eager one")
        for rc in c["ranks"]:
            if rc["backend"] != "gloo" or rc["graphed"] or any(rc["graphs"]):
                fail(f"train-dist (c) rank {rc['rank']}: backend "
                     f"{rc['backend']}, graphed {rc['graphed']}")
        check_dist_kernels("(c)", c["ranks"], DIST_C["steps"],
                           DIST_C["n_layer"])
        summaries.append(dist_summary(
            "c", c, 2 * DIST_C["batch"] * c_cfg.max_seq))
        del module, c
        shutil.rmtree(root, ignore_errors=True)
    finally:
        logging.getLogger("ray_lightning_tpu_torch").removeHandler(handler)
        fabric.shutdown()
        shutil.rmtree(DIST_ROOT, ignore_errors=True)
    gc.collect()
    kids = [k for k in child_pids() if k not in kids_before]
    mem_after = card_memory_mib()
    for row in summaries:
        print(f"[train-dist] {json.dumps(row)}")
    print(f"[train-dist] step ms: train phase {yard['step_ms']}, "
          + ", ".join(f"({x['fit']}) {x['step_ms_median']}" for x in summaries)
          + f"; card memory {mem_before} -> {mem_after} MiB; phase wall "
          f"{time.perf_counter() - t_phase:.3f} s on {card_line()}")
    if kids:
        fail(f"train-dist: child processes left: {kids}")
    if mem_after > mem_before + FLEET_MEM_SLACK_MIB:
        fail(f"train-dist: card memory {mem_after} MiB after the phase, "
             f"{mem_before} MiB before (slack {FLEET_MEM_SLACK_MIB})")
    return launches


GSPMD_ROOT = os.path.join(HERE, "build", "smoke_train_gspmd")
#: Steps of every train-gspmd fit.
GSPMD_STEPS = 6
#: (c): fp32, full width, 4 layers, two ranks sharing the card.
GSPMD_C = dict(n_layer=4, batch=8)
#: Relative gap allowed between (b)'s bf16 losses and phase 14's: the
#: model ranks' partial sums are reduced in another order.
GSPMD_LOSS_RTOL = 1e-2


def collective_timer():
    """An ``init_hook`` for launched fits: each worker times its
    ``all_reduce`` and all-gather calls (seconds, count in
    ``torch.distributed._smoke_collective_s``, which the probe reads),
    each after a device sync, so a call's time is its own and not the
    wait for the kernels before it (a gloo collective of a CUDA tensor
    syncs the stream anyway)."""

    def install():
        import functools
        import time as _time

        import torch
        import torch.distributed as dist

        acc = dist._smoke_collective_s = [0.0, 0]

        def timed(fn):
            @functools.wraps(fn)
            def call(*args, **kwargs):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                t0 = _time.perf_counter()
                out = fn(*args, **kwargs)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                acc[0] += _time.perf_counter() - t0
                acc[1] += 1
                return out
            return call

        for name in ("all_reduce", "all_gather_single",
                     "all_gather_into_tensor"):
            if hasattr(dist, name):
                setattr(dist, name, timed(getattr(dist, name)))

    return install


def tp_kernel_rows(gen) -> dict:
    """K1, K2 and K3 at a tensor-parallel rank's training call (GPT-2
    small at a model extent of 2: B=8, S=1024, H=6 local heads, D=64,
    bf16, the strided views of the rank's fused projection) held against
    their plain versions, then timed beside the plain versions, SDPA and
    their bounds."""
    import importlib

    fa = importlib.import_module("ray_lightning_tpu_torch.ops.flash_attention")
    q, k, v, do, out, lse = training_bwd_inputs(gen, heads=6)
    scale = q.shape[-1] ** -0.5
    check_training_call(fa, q, k, v, do, out, lse, scale)
    rows = {"flash_fwd": time_fwd_training_call(fa, q, k, v, out, lse,
                                                scale)}
    rows.update(time_bwd_training_call(fa, q, k, v, do, out, lse, scale))
    for row in rows.values():
        row["shape"] = list(q.shape)
    return rows


def phase_train_gspmd(yard: dict):
    """train-gspmd: ``GSPMDStrategy`` through ``Trainer.fit`` and the
    launcher. (a) World 1 on NCCL, graphed, bitwise phase 14's first 6
    steps; (b) two ranks sharing the card over gloo at a model extent of
    2 (6 of the 12 heads and 1536 of the 3072 MLP columns each, ``wte``
    whole: vocab 50257 is odd), eager, losses within 1e-2 of phase 14's,
    ending with an async sharded checkpoint; (c) fp32, 4 layers, against
    an in-process fit within 1e-4, under GSPMD and under ZeRO-3 on two
    shared-card ranks; (d) (b)'s checkpoint restored in process on the
    card through ``Trainer.fit(ckpt_path=...)``, bitwise. Returns each kernel's launches on the phase's fits and
    the kernels' rows at the tensor-parallel shape."""
    import gc

    import torch

    from ray_lightning_tpu_torch import fabric
    from ray_lightning_tpu_torch.models.gpt import GPTLM, GPTConfig
    from ray_lightning_tpu_torch.strategies import (
        GSPMDStrategy,
        RayShardedStrategy,
    )
    from ray_lightning_tpu_torch.trainer import (
        Callback,
        ModelCheckpoint,
        Trainer,
    )
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    cfg = GPTConfig.gpt2_small()
    batch, n = 8, GSPMD_STEPS
    tokens = batch * cfg.max_seq
    quiet = dict(num_sanity_val_steps=0, limit_val_batches=0,
                 enable_model_summary=False, max_epochs=n // 2)

    def gpt2(**kw):
        return GPTLM(cfg, batch_size=batch, warmup_steps=2,
                     n_train=2 * batch, **kw)

    # The kernels at the tensor-parallel shape, before any fit.
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = tp_kernel_rows(gen)

    # (c)'s yardstick, in this process, before the card's memory is read.
    c_cfg = GPTConfig.gpt2_small(n_layer=GSPMD_C["n_layer"],
                                 compute_dtype="float32")
    c_kw = dict(max_steps=n, max_epochs=n, precision="fp32", seed=0,
                log_every_n_steps=1, limit_val_batches=0,
                num_sanity_val_steps=0, enable_checkpointing=False,
                enable_model_summary=False)

    class Losses(Callback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            self.losses.append(logs["loss"])

    c_losses = Losses()
    c_mod = GPTLM(c_cfg, batch_size=GSPMD_C["batch"], warmup_steps=2,
                  n_train=2 * GSPMD_C["batch"])
    Trainer(callbacks=[c_losses], **c_kw).fit(c_mod)
    c_yard = {"losses": c_losses.losses,
              "params": {k: (v.cpu() if torch.is_tensor(v)
                             else {m: t.cpu() for m, t in v.items()})
                         for k, v in c_mod.params.items()}}
    del c_mod
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem_before = card_memory_mib()
    kids_before = child_pids()
    summaries, launches = [], {"flash_fwd": 0, "flash_bwd_dkv": 0,
                               "flash_bwd_dq": 0}
    shapes14 = {k: tuple(t.shape) for k, t in _flat_params(yard["params"])}

    def tally(ranks):
        for r in ranks:
            for k in launches:
                launches[k] += r["launches"][k]

    try:
        # (a) one whole-card rank, NCCL, graphed: phase 14's first 6 steps.
        root = os.path.join(GSPMD_ROOT, "a")
        module = gpt2()
        # Phase 14's options but its checkpoints: they move no number.
        a = dist_fit("gspmd-a", GSPMDStrategy(num_workers=1,
                                              mesh_shape={"model": 1}),
                     module, root, n, max_epochs=n // 2, limit_val_batches=2,
                     check_val_every_n_epoch=5, enable_checkpointing=False)
        (ra,) = a["ranks"]
        tally(a["ranks"])
        digest = params_digest(module.params)
        print(f"[train-gspmd] (a) GSPMDStrategy(num_workers=1, model=1): "
              f"losses {ra['losses']}; bitwise phase 14's first {n}: losses "
              f"{ra['losses'] == yard['losses'][:n]}, params "
              f"{digest == yard['digest']}; graphs per step {ra['graphs']}")
        if ra["losses"] != yard["losses"][:n]:
            fail(f"train-gspmd (a): losses {ra['losses']} differ from phase "
                 f"14's first {n} {yard['losses'][:n]}")
        if digest != yard["digest"]:
            fail(f"train-gspmd (a): params after {n} steps differ from "
                 "phase 14's (SHA-256)")
        check_dist_kernels("gspmd (a)", a["ranks"], n, cfg.n_layer)
        if (ra["backend"] != "nccl" or not ra["graphed"]
                or ra["graphs"][0] < 1 or len(set(ra["graphs"])) != 1):
            fail(f"train-gspmd (a): backend {ra['backend']}, graphed "
                 f"{ra['graphed']}, graphs per step {ra['graphs']}: expected "
                 "nccl, graphed, frozen after the first step")
        summaries.append(dist_summary("gspmd-a", a, tokens))
        del module, a
        shutil.rmtree(root, ignore_errors=True)

        # (b) two ranks on the one card at model=2, gloo, eager, ending
        # with an async sharded checkpoint (d).
        root = os.path.join(GSPMD_ROOT, "b")
        module = gpt2()
        ck = ModelCheckpoint(dirpath=os.path.join(root, "ckpts"),
                             save_sharded=True, save_last=True)
        b = dist_fit("gspmd-b", GSPMDStrategy(
            num_workers=2, mesh_shape={"model": 2},
            resources_per_worker={"GPU": 0.5},
            init_hook=collective_timer()), module, root, n, callbacks=[ck],
            async_checkpointing=True, **quiet)
        tally(b["ranks"])
        got = b["ranks"][0]["losses"]
        gaps = [abs(x - y) / abs(y) for x, y in zip(got, yard["losses"])]
        gathered = {k: tuple(t.shape) for k, t in _flat_params(module.params)}
        print(f"[train-gspmd] (b) GSPMDStrategy(2 ranks, model=2, GPU=0.5): "
              f"losses {got}; phase 14's {yard['losses'][:n]}; largest "
              f"relative gap {max(gaps)}; local shapes "
              f"{[r['local_shapes'] for r in b['ranks']]}; seconds and calls "
              f"inside gloo collectives by step end "
              f"{[r['collective_s'] for r in b['ranks']]}")
        if len(got) != n or not all(math.isfinite(x) for x in got):
            fail(f"train-gspmd (b): losses {got}")
        if max(gaps) > GSPMD_LOSS_RTOL:
            fail(f"train-gspmd (b): losses {got} differ from phase 14's "
                 f"{yard['losses'][:n]} by {max(gaps)} relative "
                 f"> {GSPMD_LOSS_RTOL}")
        for rb in b["ranks"]:
            if rb["losses"] != got:
                fail("train-gspmd (b): the ranks logged different losses")
            want = {"wqkv": [12, 768, 3, 6, 64], "wi": [12, 768, 1536],
                    "wte": [50257, 768]}
            if rb["local_shapes"] != want:
                fail(f"train-gspmd (b) rank {rb['rank']}: local shapes "
                     f"{rb['local_shapes']}, expected {want}")
            if (rb["backend"] != "gloo" or rb["graphed"]
                    or any(rb["graphs"])):
                fail(f"train-gspmd (b) rank {rb['rank']}: backend "
                     f"{rb['backend']}, graphed {rb['graphed']}")
        check_dist_kernels("gspmd (b)", b["ranks"], n, cfg.n_layer,
                           fwd_want=cfg.n_layer * n)
        if gathered != shapes14:
            fail(f"train-gspmd (b): the driver's parameters have shapes "
                 f"{gathered}, phase 14's {shapes14}")
        sb = dist_summary("gspmd-b", b, tokens)
        # Per step, over the steps whose median is the step time: the
        # seconds inside gloo calls, their calls, and their share of the
        # step (a step that also writes a checkpoint is longer).
        for rb in b["ranks"]:
            coll, ends = rb["collective_s"], rb["ends"]
            window = range(3, len(ends))
            secs = [coll[i][0] - coll[i - 1][0] for i in window]
            rank = rb["rank"]
            sb[f"collective_s_per_step_rank{rank}"] = statistics_median(secs)
            sb[f"collective_calls_per_step_rank{rank}"] = statistics_median(
                [coll[i][1] - coll[i - 1][1] for i in window])
            sb[f"collective_share_rank{rank}"] = statistics_median(
                [x / (ends[i] - ends[i - 1]) for x, i in zip(secs, window)])
        summaries.append(sb)

        # (d) the sharded checkpoint restored in process on the card
        # through the trainer: a fit resumed from it at its last step (no
        # step left) reads the directory, places the whole parameters on
        # the card and restores the step counter.
        last = ck.last_model_path
        restored = gpt2()
        resume = Trainer(max_steps=n, enable_checkpointing=False, **quiet)
        resume.fit(restored, ckpt_path=last)
        on_card = dict(_flat_params(restored.params))
        same = (on_card.keys() == dict(_flat_params(module.params)).keys()
                and all(on_card[k].is_cuda and torch.equal(on_card[k].cpu(), t)
                        for k, t in _flat_params(module.params)))
        print(f"[train-gspmd] (d) async sharded checkpoint {last}: files "
              f"{sorted(os.listdir(os.path.join(last, 'state')))}; "
              f"Trainer.fit(ckpt_path=last) on the card: step "
              f"{resume.global_step}, parameters on the card bitwise (b)'s "
              f"gathered parameters: {same}")
        if resume.global_step != n or not same:
            fail(f"train-gspmd (d): restored step {resume.global_step}, "
                 f"bitwise {same}")
        del module, b, restored, resume, on_card
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(root, ignore_errors=True)

        # (c) fp32, 4 layers, against the in-process fit, within 1e-4;
        # ZeRO-3 (gathered layer by layer) beside ZeRO-1 on the same shape.
        c_records = {}
        for tag, strat, per_rank in (
            ("gspmd-c", GSPMDStrategy(num_workers=2, mesh_shape={"model": 2},
                                      resources_per_worker={"GPU": 0.5}),
             GSPMD_C["batch"]),
            ("zero1-c", RayShardedStrategy(num_workers=2, zero_stage=1,
                                           resources_per_worker={"GPU": 0.5}),
             GSPMD_C["batch"] // 2),
            ("zero3-c", RayShardedStrategy(num_workers=2, zero_stage=3,
                                           resources_per_worker={"GPU": 0.5}),
             GSPMD_C["batch"] // 2),
        ):
            root = os.path.join(GSPMD_ROOT, tag)
            module = GPTLM(c_cfg, batch_size=per_rank, warmup_steps=2,
                           n_train=2 * GSPMD_C["batch"])
            c = dist_fit(tag, strat, module, root, n,
                         **{k: v for k, v in c_kw.items()
                            if k not in ("max_steps", "seed",
                                         "log_every_n_steps")})
            tally(c["ranks"])
            got = c["ranks"][0]["losses"]
            worst = max(abs(x - y) / abs(y)
                        for x, y in zip(got, c_yard["losses"]))
            pdiff = params_max_diff(module.params, c_yard["params"])
            print(f"[train-gspmd] ({tag}) fp32 {GSPMD_C['n_layer']} layers, "
                  f"2 ranks at GPU=0.5: losses {got} vs the in-process fit's "
                  f"{c_yard['losses']}: worst relative {worst}; params max "
                  f"abs diff {pdiff}")
            if len(got) != n or worst > 1e-4 or pdiff > 1e-4:
                fail(f"train-gspmd ({tag}): losses {got} vs "
                     f"{c_yard['losses']} (worst relative {worst}), params "
                     f"diff {pdiff}: the bar is 1e-4")
            check_dist_kernels(f"({tag})", c["ranks"], n, GSPMD_C["n_layer"])
            summaries.append(dist_summary(
                tag, c, GSPMD_C["batch"] * c_cfg.max_seq))
            c_records[tag] = [{k: r[k] for k in (
                "rank", "peak_mem_gib", "reserved_gib", "at_rest_mib",
                "gather_stats")} for r in c["ranks"]]
            del module, c
            shutil.rmtree(root, ignore_errors=True)
        # ZeRO-3's peak per rank below ZeRO-1's by at least half the
        # run's fp32 parameter bytes: no full leaf, and no gradient of
        # the whole tree, is alive in its step.
        c_param_bytes = sum(t.numel() * 4
                            for t in tree_leaves(c_yard["params"]))
        for r1, r3 in zip(c_records["zero1-c"], c_records["zero3-c"]):
            cut = (r1["peak_mem_gib"] - r3["peak_mem_gib"]) * 2**30
            print(f"[train-gspmd] (c) rank {r3['rank']}: peak allocated "
                  f"zero1 {r1['peak_mem_gib']} GiB, zero3 "
                  f"{r3['peak_mem_gib']} GiB (cut {cut / 1e6} MB; the bar "
                  f"{c_param_bytes / 2e6} MB, half the {c_param_bytes} fp32 "
                  f"parameter bytes); reserved {r1['reserved_gib']} / "
                  f"{r3['reserved_gib']} GiB; between steps "
                  f"{r1['at_rest_mib']} / {r3['at_rest_mib']} MiB; zero3's "
                  f"gathers and reductions {r3['gather_stats']}")
            st = r3["gather_stats"] or {}
            if (cut < c_param_bytes / 2 or not st.get("gathers")
                    or not st.get("reductions") or st.get("peak_layers", 9)
                    > 2):
                fail(f"train-gspmd (c) rank {r3['rank']}: zero3 peak "
                     f"{r3['peak_mem_gib']} GiB vs zero1 "
                     f"{r1['peak_mem_gib']} GiB: cut {cut} B, the bar "
                     f"{c_param_bytes / 2} B; gathers {st}")
    finally:
        fabric.shutdown()
        shutil.rmtree(GSPMD_ROOT, ignore_errors=True)
        shutil.rmtree(DIST_ROOT, ignore_errors=True)
    gc.collect()
    kids = [k for k in child_pids() if k not in kids_before]
    mem_after = card_memory_mib()
    for row in summaries:
        print(f"[train-gspmd] {json.dumps(row)}")
    print(f"[train-gspmd] step ms: phase 14 {yard['step_ms']}, "
          + ", ".join(f"({x['fit']}) {x['step_ms_median']}" for x in summaries)
          + f"; card memory {mem_before} -> {mem_after} MiB; phase wall "
          f"{time.perf_counter() - t_phase:.3f} s on {card_line()}")
    if kids:
        fail(f"train-gspmd: child processes left: {kids}")
    if mem_after > mem_before + FLEET_MEM_SLACK_MIB:
        fail(f"train-gspmd: card memory {mem_after} MiB after the phase, "
             f"{mem_before} MiB before (slack {FLEET_MEM_SLACK_MIB})")
    n_params = sum(t.numel() for t in tree_leaves(yard["params"]))
    print(f"[train-gspmd] GPT-2 small parameters {n_params}")
    return launches, rows


#: serve-mesh: one tensor-parallel gang (``"2x1"``: two ranks, 6 of the 12
#: heads and 1536 of the 3072 MLP columns each, ``wte`` whole) through
#: ``start_replicas(hosts_per_replica=2)``. (a) runs each rank at
#: MESH_GPUS of the card; (b) at MESH_GPUS_B, so the gang's pre-spawned
#: replacement fits beside it, with a ``preempt`` fault (MESH_GRACE_S of
#: grace) on the follower and a supervisor ticking every MESH_TICK_S.
MESH_SPEC = "2x1"
MESH_GPUS = 0.5
MESH_GPUS_B = 0.25
MESH_GRACE_S = 60.0
MESH_TICK_S = 0.25
#: (b)'s leader waits this long at each fold boundary once every request
#: is admitted, so the residents are still decoding when the notice lands.
MESH_DRAIN_DELAY_S = 0.5
MESH_ENV = {"RLT_HEARTBEAT_S": "0.5"}
#: (c): the gang's KV plane, a gang and an unsplit replica on the chunked
#: engine of serve-fleet (their admissions run the chunk code, bitwise the
#: solo under the reference attention on one card; no K1), joined by the
#: fleet KV plane, both on one KV store. Prompts (greedy, SERVE_NEW new
#: tokens each): the gang ships the first to the unsplit replica, the
#: unsplit replica ships the second to the gang, and the third goes from
#: the gang's park into the store and back out to the unsplit replica.
MESH_KV_LENGTHS = (200, 300, 130)
MESH_KV_GPUS = 0.25


def mesh_compare(tag, reqs, got, exact, params, cfg, device) -> tuple:
    """Each request's tokens against the serve phase's in-process engine
    (``exact``): a greedy token may differ only where that engine's next
    token was a near-tie (``draw_margin`` below MARGIN). The split sums its
    fp32 partial products in another order and rounds the sum to bf16, so
    a hidden state can land one bf16 step off the unsplit one; a sampled
    request's top-k / top-p cut and Gumbel draw see those logits, and its
    differences are reported with their margins, not gated (the serve
    phase holds no sampled request against a solo either). Returns (greedy
    requests that differ, sampled requests that differ)."""
    near, sampled = 0, 0
    for rid, prompt, sp in reqs:
        want = exact[rid]
        if got[rid] == want:
            continue
        j = next((j for j, (a, b) in enumerate(zip(got[rid], want))
                  if a != b), None)
        if j is None:
            fail(f"{tag} {rid}: {len(got[rid])} tokens, {len(want)} wanted")
        margin = draw_margin(params, cfg, prompt + want[:j], sp, j, device)
        gated = sp.temperature <= 0
        print(f"[serve-mesh] {tag} {rid}: differs from the in-process engine "
              f"first at token {j} ({'greedy' if gated else 'sampled'}), "
              f"its margin {margin}{'' if gated else ' (reported)'}")
        if not gated:
            sampled += 1
            continue
        if margin >= MARGIN:
            fail(f"{tag} {rid}: mismatch at token {j} with margin {margin}")
        near += 1
    return near, sampled


def gang_of(client, idx: int = 0) -> list:
    """Replica ``idx``'s gang: the leader's actor, then its followers."""
    return [client._actor(idx)] + client.followers_of(idx)


def gang_rows(gang: list) -> list:
    """Every rank's ``stats()`` (kernel counts, collectives, memory,
    graphs, backend, start-up), leader first."""
    from ray_lightning_tpu_torch import fabric

    return fabric.get([a.stats.remote() for a in gang], timeout=300)


def gang_digests(gang: list) -> list:
    """Each rank's digest of the tokens its engine emitted, leader first,
    once every follower has replayed as many ops as the leader ran (a
    follower records its last op a moment after the leader's client has
    seen its tokens)."""
    from ray_lightning_tpu_torch import fabric

    deadline = time.monotonic() + 60
    while True:
        out = fabric.get([a.token_digest.remote() for a in gang],
                         timeout=300)
        if len({d["ops"] for d in out}) == 1 or time.monotonic() > deadline:
            return out
        time.sleep(0.05)


def check_gang(tag, before, after, cfg, cuda: bool, kv_bytes: int) -> dict:
    """Gates on each rank of a gang over a stretch of traffic (``before``
    and ``after`` from :func:`gang_rows`): gloo, eager, the graph count
    frozen, each rank's KV cache half the unsplit engine's ``kv_bytes``,
    and on the card K1 12 times per admission on every rank and the
    reference path never. Returns the K1 launches and per-rank records."""
    admitted = after[0]["admitted"] - before[0]["admitted"]
    launches, ranks = 0, []
    for r, (a, b) in enumerate(zip(before, after)):
        k1 = b["kernels"]["launches"] - a["kernels"]["launches"]
        ref = b["kernels"]["reference"] - a["kernels"]["reference"]
        calls = b["collectives"]["calls"] - a["collectives"]["calls"]
        secs = b["collectives"]["seconds"] - a["collectives"]["seconds"]
        kv = b["memory"]["kv_cache"]
        launches += k1
        ranks.append({"rank": r, "k1_launches": k1, "reference": ref,
                      "all_reduces": calls, "gloo_s": secs,
                      "kv_per_device_bytes": kv["per_device_bytes"],
                      "kv_bytes": kv["bytes"], "backend": b["backend"],
                      "graphed": b["graphed"],
                      "compiled_count": b["compiled_count"]})
        if (b["backend"], b["graphed"], b["mesh"]) != ("gloo", False,
                                                       MESH_SPEC):
            fail(f"{tag} rank {r}: backend {b['backend']}, graphed "
                 f"{b['graphed']}, mesh {b['mesh']}")
        if b["compiled_count"] != a["compiled_count"]:
            fail(f"{tag} rank {r}: compiled_count moved {a['compiled_count']}"
                 f" -> {b['compiled_count']}")
        if kv["bytes"] != kv_bytes or kv["per_device_bytes"] * 2 != kv_bytes:
            fail(f"{tag} rank {r}: KV cache {kv}, the unsplit engine's "
                 f"{kv_bytes} bytes")
        if cuda and (k1 != admitted * cfg.n_layer or ref):
            fail(f"{tag} rank {r}: K1 launches {k1} for {admitted} "
                 f"admissions ({cfg.n_layer} each), reference calls {ref}")
        if b.get("error"):
            fail(f"{tag} rank {r}: its op loop stopped: {b['error']}")
    print(f"[serve-mesh] {tag}: {admitted} admissions; "
          f"{json.dumps(ranks)}")
    return {"launches": launches, "ranks": ranks, "admitted": admitted}


def serve_mesh_run(params, cfg, device, ckpt: str, reqs, exact: dict,
                   kv_bytes: int) -> dict:
    """The serve-mesh traffic (see ``phase_serve_mesh``) on ``device``:
    ``reqs`` are the serve phase's requests, ``exact`` its in-process
    engine's tokens and ``kv_bytes`` that engine's KV cache. On the CPU (a
    rehearsal at a tiny width) set ``RLT_NUM_GPUS`` so the fabric has a
    card to share out; the launch gate then checks nothing."""
    import torch

    from ray_lightning_tpu_torch import fabric
    from ray_lightning_tpu_torch.obs.events import EventLog
    from ray_lightning_tpu_torch.obs.registry import get_registry
    from ray_lightning_tpu_torch.serve.client import start_replicas
    from ray_lightning_tpu_torch.serve.supervisor import FleetSupervisor

    cuda = torch.device(device).type == "cuda"
    out = {}
    fabric.init()
    try:
        # -- (a) the gang at half a card per rank -----------------------
        t0 = time.perf_counter()
        client = start_replicas(
            1, hosts_per_replica=2, mesh=MESH_SPEC,
            num_gpus_per_replica=MESH_GPUS, ckpt_path=ckpt, device=device,
            env=MESH_ENV, rpc_timeout_s=300.0, init_timeout=600.0,
            **SERVE_ENGINE)
        spawn_wall = time.perf_counter() - t0
        cards = [a.visible_cards for a in
                 [client._actor(0)] + client.followers_of(0)]
        if cards != [["0"], ["0"]]:
            fail(f"serve-mesh (a): the gang's ranks landed on {cards}")
        gang = gang_of(client)
        before = gang_rows(gang)
        w = fleet_wave(client, reqs)
        after = gang_rows(gang)
        gate = check_gang("(a)", before, after, cfg, cuda, kv_bytes)
        near, sampled_diff = mesh_compare("(a)", reqs, w["toks"], exact,
                                          params, cfg, device)
        digests = gang_digests(gang)
        if len({d["sha256"] for d in digests}) != 1 or not digests[0][
                "tokens"]:
            fail(f"serve-mesh (a): the ranks' token digests differ: "
                 f"{digests}")
        lead = after[0]
        ttfts = sorted(w["ttft"].values())
        n_tok = sum(len(t) for t in w["toks"].values())
        folds = sum(int(n) for n in lead["fold_k"]["dispatches"].values())
        out["a"] = {
            "spawn_wall_s": spawn_wall,
            "rank_startup_s": [r["startup"]["init_end"]
                               - r["startup"]["worker_t0"] for r in after],
            "requests": len(reqs),
            "near_tie_mismatches": near,
            "sampled_differ": sampled_diff,
            "ttft_p50_s": ttfts[len(ttfts) // 2],
            "ttft_max_s": ttfts[-1],
            "tokens_per_s": n_tok / w["wall"],
            "wall_s": w["wall"],
            "ms_per_step_p50": 1e3 * lead.get("step_time_p50_s",
                                              float("nan")),
            "folds": folds,
            "admissions": gate["admitted"],
            "all_reduces": [r["all_reduces"] for r in gate["ranks"]],
            "gloo_s": [r["gloo_s"] for r in gate["ranks"]],
            "gloo_s_per_fold": [r["gloo_s"] / folds for r in gate["ranks"]],
            "gloo_share_of_wave": [r["gloo_s"] / w["wall"]
                                   for r in gate["ranks"]],
            "kv_per_device_bytes": [r["kv_per_device_bytes"]
                                    for r in gate["ranks"]],
            "kv_bytes_unsplit": kv_bytes,
            "digest": digests[0],
        }
        if cuda:
            out["a"]["card_mib"] = card_memory_mib()
        print(f"[serve-mesh] (a) {json.dumps(out['a'])}")
        launches = gate["launches"]
        client.shutdown()

        # -- (b) a follower's preemption: drained, respawned as a unit ----
        reg = get_registry()

        def lost_count():
            return (reg.counter("rlt_serve_failover_requests_total").value(
                outcome="lost") + reg.counter(
                "rlt_serve_preempt_requests_total").value(outcome="lost"))

        # Every request admitted in the wave's first step, so none is
        # queued when the notice lands (a queued request migrates, and this
        # fleet has no survivor to take it); the tokens do not depend on it.
        t0 = time.perf_counter()
        client = start_replicas(
            1, hosts_per_replica=2, mesh=MESH_SPEC,
            num_gpus_per_replica=MESH_GPUS_B, ckpt_path=ckpt, device=device,
            env=MESH_ENV, rpc_timeout_s=300.0, init_timeout=600.0,
            max_prefills_per_step=len(reqs), **SERVE_ENGINE)
        spawn_b = time.perf_counter() - t0
        sup_events = EventLog()
        sup = FleetSupervisor(client, interval_s=MESH_TICK_S,
                              events=sup_events)
        lost0 = lost_count()
        old = gang_of(client)
        before = gang_rows(old)
        sup.start()
        try:
            # Armed once every request is admitted (each has its first
            # token): the drain finds them all resident, and with no
            # survivor in the fleet they must finish in the grace window.
            def all_admitted(handles, t_first):
                return len(t_first) == len(wave)

            def preempt_follower(handles):
                client.inject_fault(0, [
                    {"point": "fold_boundary", "action": "delay",
                     "seconds": MESH_DRAIN_DELAY_S, "after": k}
                    for k in range(1, 40)])
                client.inject_fault(0, [{"point": "follower_op",
                                         "action": "preempt",
                                         "seconds": MESH_GRACE_S}],
                                    follower=0)

            wave = [(f"{rid}b", p, sp) for rid, p, sp in reqs]
            try:
                wb = fleet_wave(client, wave,
                                trigger=(all_admitted, preempt_follower))
            except SystemExit:
                print("[serve-mesh] (b) supervisor events: "
                      f"{json.dumps(sup_events.tail(64), default=str)}")
                raise
            try:
                # The old gang's launches, while it still lives (the
                # swap kills it once the client has seen every finish).
                old_after = gang_rows(old)
            except Exception:  # noqa: BLE001 - already swapped out
                old_after = None
            deadline = time.monotonic() + 600
            while not event_ts(sup_events, "replica_preempt_replaced",
                               replica=0):
                if time.monotonic() > deadline or sup.rows()[0]["state"] in (
                        "failed", "dead"):
                    fail(f"serve-mesh (b): the gang was not replaced: "
                         f"{sup.rows()[0]}; events "
                         f"{[e['name'] for e in sup_events.tail(64)]}")
                time.sleep(0.05)
        finally:
            sup.stop()
        (ev,) = [e for e in sup_events.tail(256)
                 if e["name"] == "replica_preempting"]
        (drained,) = [e for e in sup_events.tail(256)
                      if e["name"] == "replica_preempt_drained"]
        swapped = event_ts(sup_events, "replica_preempt_replaced",
                           replica=0)[0]
        new = gang_of(client)
        lost = lost_count() - lost0
        if (ev.get("member") != "follower" or lost or drained["lost"]
                or not drained["finished_in_grace"]):
            fail(f"serve-mesh (b): member {ev.get('member')}, lost {lost}, "
                 f"drain {drained} (its residents must finish in grace)")
        if any(a is b for a in new for b in old) or any(
                a.is_alive() for a in old):
            fail("serve-mesh (b): the gang was not replaced as a unit")
        got_b = {rid[:-1]: t for rid, t in wb["toks"].items()}
        if got_b != w["toks"]:
            fail(f"serve-mesh (b): the preempted gang's tokens differ from "
                 f"(a)'s: {got_b} vs {w['toks']}")
        again = [(f"{rid}c", p, sp) for rid, p, sp in reqs]
        mid = gang_rows(new)
        wc = fleet_wave(client, again)
        end = gang_rows(new)
        gate_c = check_gang("(b) fresh gang", mid, end, cfg, cuda, kv_bytes)
        got_c = {rid[:-1]: t for rid, t in wc["toks"].items()}
        if got_c != w["toks"]:
            fail(f"serve-mesh (b): the fresh gang's tokens differ from "
                 f"(a)'s: {got_c} vs {w['toks']}")
        launches += gate_c["launches"]
        if old_after is not None:
            launches += check_gang("(b) preempted gang", before, old_after,
                                   cfg, cuda, kv_bytes)["launches"]
        out["b"] = {
            "spawn_wall_s": spawn_b,
            "finished_in_grace": drained["finished_in_grace"],
            "migrated": drained["migrated"],
            "lost": lost,
            "notice_to_swap_s": swapped - event_ts(
                sup_events, "replica_preempting", replica=0)[0],
            "fresh_rank_startup_s": [r["startup"]["init_end"]
                                     - r["startup"]["worker_t0"]
                                     for r in end],
            "old_gang_counted": old_after is not None,
        }
        print(f"[serve-mesh] (b) {json.dumps(out['b'])}")
        client.shutdown()

        # -- (c) the gang's KV plane and store ----------------------------
        out["c"] = mesh_kv_run(params, cfg, device, ckpt)
        launches += out["c"]["k1_launches"]
    finally:
        fabric.shutdown()
    out["launches"] = launches
    return out


def mesh_kv_run(params, cfg, device, ckpt: str) -> dict:
    """serve-mesh (c): a ``"2x1"`` gang at ``role="decode"`` and an
    unsplit replica at ``role="mixed"`` (``start_replicas`` twice, the
    fleet KV plane on, one KV store; each names the other as its peer 1;
    a client refuses a fleet of prefill replicas alone, and a request's
    ``ship_to`` makes either one its prefill side).
    The gang prefills the first prompt and ships its blocks (exported:
    every rank's heads gathered over the model group) to the unsplit
    replica, where the request's resubmission admits warm; the unsplit
    replica ships the second prompt to the gang (each rank keeps its
    heads); the gang serves the third and parks it (its chain written
    whole to the store) and the unsplit replica's resubmission with a
    store hint reads it back warm. Gates: every ship and the park land
    (the receiver's hit tokens > 0, every block stored) and every greedy
    stream equals the solo ``gpt_generate`` under the reference attention
    except at near-ties (the split rounds its fp32 sum to bf16 once).
    Reported per ship: its bytes, the seconds from the submit to the
    shipped terminal (the prefill, the export, the send), the gang's
    gather seconds; each rank's K1 launches per admission (0: the chunked
    engines prefill through the chunk code; (a) and (b) hold K1 on the
    gang's admissions). Returns the part's record."""
    import dataclasses

    import numpy as np

    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.serve.client import start_replicas
    from ray_lightning_tpu_torch.serve.router import prompt_block_digests

    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in MESH_KV_LENGTHS]
    store = os.path.join(os.path.dirname(ckpt), "store")
    common = dict(ckpt_path=ckpt, device=device, env=MESH_ENV,
                  rpc_timeout_s=300.0, init_timeout=600.0, kvfleet=True,
                  kvstore_dir=store, **FLEET_KV, **FLEET_CHUNKED_ENGINE)
    gang = start_replicas(1, hosts_per_replica=2, mesh=MESH_SPEC,
                          num_gpus_per_replica=MESH_KV_GPUS, roles="decode",
                          **common)
    whole = start_replicas(1, num_gpus_per_replica=MESH_KV_GPUS,
                           roles="mixed", **common)
    spawn_s = time.perf_counter() - t0
    try:
        gang._rpc(0, "register_kv_peer", 1, whole._kv_queues[0])
        whole._rpc(0, "register_kv_peer", 1, gang._kv_queues[0])
        members = gang_of(gang)

        def rows():
            return gang_rows(members) + [whole._rpc(0, "stats")]

        def run(client, rid, prompt, **kw):
            """Submit on the client's replica and read to the end: the
            tokens, the terminal status and the seconds."""
            t = time.perf_counter()
            client._rpc(0, "submit", prompt, max_new_tokens=SERVE_NEW,
                        request_id=rid, **kw)
            got, cur = [], 0
            deadline = time.monotonic() + 120
            while True:
                res = client._rpc(0, "result", rid, cur, wait_s=0.5)
                got += res["tokens"]
                cur += len(res["tokens"])
                if res["done"]:
                    return got, res["status"], time.perf_counter() - t
                if time.monotonic() > deadline:
                    fail(f"serve-mesh (c) {rid}: no end in 120 s; the "
                         f"gang's errors {[r.get('error') for r in rows()]}")

        def hits(row):
            return row["prefix"]["hit_tokens"]

        before = rows()
        ships, toks = [], {}
        for rid, src, dst, prompt in (("kv0", gang, whole, prompts[0]),
                                      ("kv1", whole, gang, prompts[1])):
            a = rows()
            first, status, secs = run(src, rid, prompt, ship_to=1)
            mid = rows()
            full, end_status, _ = run(dst, rid, prompt)
            b = rows()
            src_row, dst_row = ((a[0], mid[0]), (a[2], b[2])) if (
                src is gang) else ((a[2], mid[2]), (a[0], b[0]))
            ship = {
                "request": rid,
                "from": "gang" if src is gang else "unsplit",
                "status": [status, end_status],
                "blocks": (src_row[1]["kvfleet"]["ship_blocks"]
                           - src_row[0]["kvfleet"]["ship_blocks"]),
                "bytes": (src_row[1]["kvfleet"]["ship_bytes"]
                          - src_row[0]["kvfleet"]["ship_bytes"]),
                "submit_to_shipped_s": secs,
                "gang_gather_s": (mid[0]["kv_gather"]["seconds"]
                                  - a[0]["kv_gather"]["seconds"]),
                "gang_gather_bytes": (mid[0]["kv_gather"]["bytes"]
                                      - a[0]["kv_gather"]["bytes"]),
                "receiver_hit_tokens": hits(dst_row[1]) - hits(dst_row[0]),
            }
            ships.append(ship)
            toks[rid] = full
            if (status != "shipped" or end_status != "finished"
                    or not ship["blocks"] or ship["receiver_hit_tokens"] <= 0
                    or first[:1] != full[:1]):
                fail(f"serve-mesh (c) {rid}: {ship}; first {first}")
        # The store: the gang serves the third prompt, parks it (its
        # chain gathered and written whole), the unsplit replica reads it
        # back warm through a store hint.
        a = rows()
        toks["kv2-gang"], _, _ = run(gang, "kv2", prompts[2])
        parked = gang._rpc(0, "park_session", prompts[2])
        digs = [d.hex() for d in prompt_block_digests(
            prompts[2], FLEET_CHUNKED_ENGINE["prefix_block"])]
        full, status, secs = run(whole, "kv2-read", prompts[2], kv_hint={
            "peer": None, "store": True, "digests": digs})
        b = rows()
        toks["kv2"] = full
        stored = {"parked": parked, "read_s": secs, "status": status,
                  "receiver_hit_tokens": hits(b[2]) - hits(a[2]),
                  "gang_gather_s": (b[0]["kv_gather"]["seconds"]
                                    - a[0]["kv_gather"]["seconds"])}
        if (parked.get("stored") != len(digs) or not digs
                or stored["receiver_hit_tokens"] <= 0):
            fail(f"serve-mesh (c) store: {stored}, {len(digs)} blocks")
        after = rows()
        # A follower's admissions are its leader's (it replays them).
        adm = [after[i]["admitted"] - before[i]["admitted"]
               for i in (0, 0, 2)]
        ranks = []
        for r, (x, y) in enumerate(zip(before, after)):
            k1 = y["kernels"]["launches"] - x["kernels"]["launches"]
            ranks.append({
                "rank": ("gang leader", "gang follower", "unsplit")[r],
                "k1_launches": k1, "admissions": adm[r],
                "k1_per_admission": k1 / max(1, adm[r]),
                "reference": y["kernels"]["reference"]
                - x["kernels"]["reference"],
                "error": y.get("error")})
        if any(r["error"] for r in ranks):
            fail(f"serve-mesh (c): a rank's op loop stopped: {ranks}")
        digests = gang_digests(members)
        if len({d["sha256"] for d in digests}) != 1:
            fail(f"serve-mesh (c): the gang's ranks emitted different "
                 f"tokens: {digests}")
    finally:
        gang.shutdown()
        whole.shutdown()
    # Greedy streams against the solo under the reference attention.
    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    near = 0
    for rid, prompt in (("kv0", prompts[0]), ("kv1", prompts[1]),
                        ("kv2-gang", prompts[2]), ("kv2", prompts[2])):
        solo = gpt.gpt_generate(params, ref_cfg, [prompt], SERVE_NEW,
                                device=device)[0, len(prompt):].tolist()
        got = toks[rid]
        if got == solo:
            continue
        j = next((j for j, (x, y) in enumerate(zip(got, solo)) if x != y),
                 None)
        if j is None:
            fail(f"serve-mesh (c) {rid}: {len(got)} tokens, solo "
                 f"{len(solo)}")
        margin = greedy_margin(params, ref_cfg, prompt + solo[:j])
        print(f"[serve-mesh] (c) {rid}: differs from the solo first at "
              f"token {j}, its margin {margin}")
        if margin >= MARGIN:
            fail(f"serve-mesh (c) {rid}: mismatch at token {j} with margin "
                 f"{margin}")
        near += 1
    rec = {"spawn_s": spawn_s, "ships": ships, "store": stored,
           "ranks": ranks, "near_tie_mismatches": near,
           "k1_launches": sum(r["k1_launches"] for r in ranks[:2]),
           "wall_s": time.perf_counter() - t0}
    print(f"[serve-mesh] (c) {json.dumps(rec, default=str)}")
    return rec


def phase_serve_mesh(serve4: dict):
    """serve-mesh: tensor-parallel serving as a gang of ranks at GPT-2
    small's full width and depth, the serve phase's weights written once
    to a checkpoint under ``build/smoke_mesh`` (removed after). First K1
    is held against its plain version at a rank's admission (B=1, S=1024,
    H=6, D=64, bf16, causal, q/k/v the strided views of the rank's slice of
    the fused projection) and timed beside SDPA and its bound. Then
    (``serve_mesh_run``) ``start_replicas(1, hosts_per_replica=2,
    mesh="2x1")`` -> ``ServeClient`` -> the leader's ``ServeReplica`` ->
    ``Scheduler`` -> ``_GangLeaderEngine`` -> ``DecodeEngine`` on each
    rank's half of the heads, the follower replaying the op stream: (a) at
    half a card per rank, the serve phase's 8 requests; (b) at a quarter
    card per rank with a ``FleetSupervisor``, a ``preempt`` fault on the
    follower under the same requests: the supervisor reads the notice
    from the follower's heartbeat, drains the gang, pre-spawns a whole
    gang and swaps it in; the fresh gang serves the requests again.
    Gates: every request finishes with its count; (a)'s greedy tokens
    equal the serve phase's in-process engine's except at near-ties
    (``draw_margin`` below MARGIN; sampled ones reported against it); both
    ranks' token digests equal; on every rank gloo,
    eager (``graphed`` False), ``compiled_count`` frozen, K1 12 times per
    admission and the reference path never, the KV cache's per-rank bytes
    half the unsplit engine's; (b) the preemption read from a follower,
    0 lost, the gang replaced as a unit (no old actor alive), the
    preempted and the fresh gang's tokens bitwise (a)'s; no child process
    left and the card's used memory back within ``FLEET_MEM_SLACK_MIB``.
    Returns K1's launches on the ranks and K1's row at the rank's
    shape."""
    import dataclasses

    import numpy as np
    import torch

    from ray_lightning_tpu_torch.models import gpt
    from ray_lightning_tpu_torch.models.gpt import params_to
    from ray_lightning_tpu_torch.parallel.mesh import Mesh
    from ray_lightning_tpu_torch.utils.state_stream import (
        state_stream_to_file, to_state_stream)

    t_phase = time.perf_counter()
    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init_gpt_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    rank0 = Mesh({"model": 2}, 0, {"model": None}, None)
    local = gpt.cast_params(gpt.gpt_param_slices(params, cfg, rank0), cfg)
    row = check_k1_prefill(local, cfg, 1, cfg.max_seq, "serve-mesh")
    del local
    if row["shape"] != [1, cfg.max_seq, cfg.n_head // 2, cfg.head_dim]:
        fail(f"serve-mesh: K1 ran at {row['shape']}, not a rank's heads")
    workdir = os.path.join(HERE, "build", "smoke_mesh")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    ckpt = os.path.join(workdir, "gpt.ckpt")
    state_stream_to_file(to_state_stream({
        "params": params_to(params, torch.device("cpu")),
        "gpt_config": dataclasses.asdict(cfg)}), ckpt)
    os.environ["RLT_REQUIRE_GPU"] = "1"
    kids0 = child_pids()
    mem0 = card_memory_mib()
    reqs = serve_workload(cfg.vocab_size, np.random.default_rng(0))
    kv_bytes = serve4["sched"].engine.memory_stats()["kv_cache"]["bytes"]
    try:
        out = serve_mesh_run(params, cfg, "cuda", ckpt, reqs, serve4["toks"],
                             kv_bytes)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and (
            set(child_pids()) - set(kids0)
            or card_memory_mib() > mem0 + FLEET_MEM_SLACK_MIB):
        time.sleep(0.5)
    kids, mem = set(child_pids()) - set(kids0), card_memory_mib()
    if kids:
        fail(f"serve-mesh: child processes left: {sorted(kids)}")
    if mem > mem0 + FLEET_MEM_SLACK_MIB:
        fail(f"serve-mesh: card memory {mem} MiB after the phase, {mem0} "
             "MiB before")
    single = sum(len(t) for t in serve4["toks"].values()) / serve4["wall"]
    summary = {
        "spawn_wall_s": out["a"]["spawn_wall_s"],
        "rank_startup_s": out["a"]["rank_startup_s"],
        "ttft_p50_s": out["a"]["ttft_p50_s"],
        "tokens_per_s": out["a"]["tokens_per_s"],
        "single_engine_tokens_per_s_phase_serve": single,
        "ms_per_step_p50": out["a"]["ms_per_step_p50"],
        "gloo_s_per_fold": out["a"]["gloo_s_per_fold"],
        "kv_per_device_bytes": out["a"]["kv_per_device_bytes"],
        "notice_to_swap_s": out["b"]["notice_to_swap_s"],
        "card_mib": [mem0, out["a"].get("card_mib"), mem],
        "k1_rank_ms": row["ms"],
        "phase_wall_s": time.perf_counter() - t_phase,
    }
    print(f"[serve-mesh] {json.dumps(summary)} on {card_line()}")
    return out["launches"], row


#: zoo (a): BERT-base's published widths (Devlin et al. 2019, Table 1; the
#: bert-base-uncased vocabulary) on the repo's pre-LN encoder, 20 steps of
#: 8 sequences of 512 tokens, validation (one batch) every 5th epoch.
ZOO_BERT = dict(vocab_size=30522, n_layer=12, n_head=12, d_model=768,
                max_seq=512, compute_dtype="bfloat16")
ZOO_BERT_STEPS = 20
#: The graphed fit's first losses held against the eager fit's.
ZOO_EAGER_STEPS = 4
#: zoo (b): ViT-Base's widths (Dosovitskiy et al. 2021, Table 1) at 224 px,
#: patches of 16: 197 rows, which the shared shape rule sends to the
#: reference attention.
ZOO_VIT = dict(image_size=224, patch_size=16, n_layer=12, n_head=12,
               d_model=768, d_ff=3072, compute_dtype="bfloat16")
ZOO_VIT_STEPS = 10
ZOO_RESNET_STEPS = 20
#: fp32 logits on the card against the CPU forward on the same weights.
ZOO_LOGIT_TOL = 1e-3


def zoo_fit(module, n_steps: int, strategy=None, **kw):
    """``Trainer.fit`` of ``module`` for ``n_steps`` steps on the card; the
    trainer, its step clock, the kernel counts of the fit and its wall."""
    import torch

    from ray_lightning_tpu_torch.ops.flash_attention import counters
    from ray_lightning_tpu_torch.trainer import Callback, Trainer

    class StepClock(Callback):
        def __init__(self):
            self.ends, self.losses = [], []

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            self.ends.append(time.perf_counter())
            self.losses.append(logs["loss"])

    clock = StepClock()
    args = dict(max_steps=n_steps, max_epochs=n_steps, limit_val_batches=0,
                num_sanity_val_steps=0, enable_checkpointing=False,
                enable_model_summary=False, seed=0, log_every_n_steps=1,
                callbacks=[clock], strategy=strategy)
    args.update(kw)
    trainer = Trainer(**args)
    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.fit(module)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": counters.launches,
                "flash_bwd_dkv": counters.bwd_dkv_launches,
                "flash_bwd_dq": counters.bwd_dq_launches,
                "reference": counters.reference}
    if trainer.global_step != n_steps or len(clock.losses) != n_steps:
        fail(f"zoo: {type(module).__name__} trained {trainer.global_step} "
             f"steps, {len(clock.losses)} losses, expected {n_steps}")
    if not all(math.isfinite(x) for x in clock.losses):
        fail(f"zoo: non-finite loss in {type(module).__name__}'s fit: "
             f"{clock.losses}")
    return trainer, clock, launches, wall


def zoo_summary(clock, items_per_step: int, unit: str) -> dict:
    """Step ms (median of steps 4..: the first 3 hold the warm-up run, the
    capture and the first replay) and items per second of a fit."""
    import torch

    steps_s = [b - a for a, b in zip(clock.ends, clock.ends[1:])]
    step_s = statistics_median(steps_s[2:])
    return {"step_ms_median": step_s * 1e3,
            "step_ms_all": [x * 1e3 for x in steps_s],
            f"{unit}_per_s": items_per_step / step_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "loss_first": clock.losses[0], "loss_last": clock.losses[-1]}


def falls(losses, n: int = 5) -> bool:
    """The mean of the last ``n`` losses is below that of the first ``n``."""
    return sum(losses[-n:]) / n < sum(losses[:n]) / n


def bert_attention_inputs(gen, cfg):
    """The attention inputs of one BERT-base training layer on the card:
    q, k, v from the encoder's fused projection (``einsum("bsd,dthk->
    bsthk")``), so they are the strided (B, S, 3, H, D) views the encoder
    hands K1, K2 and K3; a contiguous dO; out and lse from K1, non-causal."""
    import torch

    from ray_lightning_tpu_torch.ops.flash_attention import _flash_fwd_cuda

    B, S, H, D, dm = 8, cfg.max_seq, cfg.n_head, cfg.head_dim, cfg.d_model
    dt = torch.bfloat16
    a = torch.randn((B, S, dm), generator=gen, device="cuda").to(dt)
    wqkv = (torch.randn((dm, 3, H, D), generator=gen, device="cuda")
            * dm ** -0.5).to(dt)
    with torch.no_grad():
        qkv = torch.einsum("bsd,dthk->bsthk", a, wqkv)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
    out, lse = _flash_fwd_cuda(q, k, v, False, D ** -0.5, 0, 0)
    return q, k, v, do, out, lse


def zoo_bert() -> dict:
    """(a) BERT-base masked-LM pretraining through ``Trainer.fit``: K1 at
    every layer of every forward (training and validation), K2 and K3 at
    every layer of every step, non-causal, the reference path never; the
    loss falls; the graphed fit's first losses equal the eager fit's;
    ``fill_mask`` on a held-out sequence. Then BERT's attention call alone,
    held against the plain versions and timed."""
    import importlib

    import numpy as np
    import torch

    from ray_lightning_tpu_torch.models.bert import BERTConfig, BERTEncoder
    from ray_lightning_tpu_torch.models.gpt import make_fake_text
    from ray_lightning_tpu_torch.strategies.base import SingleDeviceStrategy

    class CountedBERT(BERTEncoder):
        """Counts the eval forwards (each runs eagerly, one per row)."""

        val_forwards = 0

        def validation_step(self, params, batch):
            self.val_forwards += 1
            return super().validation_step(params, batch)

    class EagerSingle(SingleDeviceStrategy):
        capture_graphs = False  # the eager baseline: no CUDA graphs

    cfg = BERTConfig(**ZOO_BERT)
    n = ZOO_BERT_STEPS
    module = CountedBERT(cfg, batch_size=8, warmup_steps=2, n_train=16)
    trainer, clock, launches, wall = zoo_fit(
        module, n, max_epochs=n // 2, limit_val_batches=1,
        check_val_every_n_epoch=5)
    forwards = n + module.val_forwards
    L = cfg.n_layer
    want = {"flash_fwd": L * forwards, "flash_bwd_dkv": L * n,
            "flash_bwd_dq": L * n, "reference": 0}
    print(f"[zoo] bert: {n} steps of BERT-base MLM (B=8, S={cfg.max_seq}, "
          f"bf16, non-causal flash) through Trainer.fit in {wall:.3f} s, "
          f"{module.val_forwards} validation forwards; launches "
          f"{json.dumps(launches)}; losses {clock.losses}")
    if launches != want:
        fail(f"zoo bert: launches {launches} != {want} (12 layers x {n} "
             f"steps, K1 also x {module.val_forwards} validation forwards; "
             f"0 reference-path calls)")
    if not falls(clock.losses):
        fail(f"zoo bert: the loss did not fall: {clock.losses}")
    run = zoo_summary(clock, 8 * cfg.max_seq, "tokens")
    run["val_loss"] = trainer.callback_metrics.get("val_loss")
    graphed = clock.losses[:ZOO_EAGER_STEPS]

    # fill_mask on a held-out sequence with 15% of its positions masked.
    toks = make_fake_text(1, seq_len=cfg.max_seq - 1, vocab=cfg.mask_id,
                          seed=11).arrays[0]
    holes = np.random.default_rng(0).random(toks.shape) < 0.15
    masked = np.where(holes, cfg.mask_id, toks)
    filled = module.fill_mask(masked).cpu().numpy()
    if not (filled[~holes] == toks[~holes]).all():
        fail("zoo bert: fill_mask changed an unmasked position")
    if (filled == cfg.mask_id).any():
        fail("zoo bert: fill_mask emitted the [MASK] id")
    run["fill_mask_recovered"] = float((filled[holes] == toks[holes]).mean())
    run["fill_mask_holes"] = int(holes.sum())
    del trainer, module
    torch.cuda.empty_cache()

    _, eager_clock, _, _ = zoo_fit(
        BERTEncoder(cfg, batch_size=8, warmup_steps=2, n_train=16),
        ZOO_EAGER_STEPS, strategy=EagerSingle("cuda"))
    eager = eager_clock.losses
    diff = max(abs(a - b) / abs(b) for a, b in zip(graphed, eager))
    run.update(graphed_losses=graphed, eager_losses=eager,
               graphed_eager_bitwise=graphed == eager,
               graphed_eager_max_rel_diff=diff)
    print(f"[zoo] bert: graphed fit's first {ZOO_EAGER_STEPS} losses "
          f"{graphed}, eager fit's {eager}, worst relative difference {diff}")
    if graphed != eager:
        fail(f"zoo bert: the graphed fit's losses {graphed} differ from the "
             f"eager fit's {eager}")
    torch.cuda.empty_cache()

    # BERT's attention call alone (B=8, S=512, H=12, D=64, bf16,
    # non-causal, q/k/v strided views of the fused projection).
    fa = importlib.import_module("ray_lightning_tpu_torch.ops.flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do, out, lse = bert_attention_inputs(gen, cfg)
    scale = q.shape[-1] ** -0.5
    check_training_call(fa, q, k, v, do, out, lse, scale, causal=False)
    rows = {"flash_fwd": time_fwd_training_call(fa, q, k, v, out, lse, scale,
                                                causal=False)}
    rows.update(time_bwd_training_call(fa, q, k, v, do, out, lse, scale,
                                       causal=False))
    print(f"[zoo] bert {json.dumps(run)} on {card_line()}")
    return {"launches": launches, "rows": rows}


def zoo_cpu_logits(forward, params, x) -> float:
    """Max abs difference of fp32 ``forward(params, x)`` on the card and on
    the CPU (the same weights and images, copied)."""
    import torch

    from ray_lightning_tpu_torch.models.gpt import params_to

    cpu = torch.device("cpu")
    with torch.no_grad():
        card = forward(params, x).float().cpu()
        host = forward(params_to(params, cpu), x.cpu()).float()
    if not (torch.isfinite(card).all() and torch.isfinite(host).all()):
        fail("zoo: non-finite logits")
    return float((card - host).abs().max())


def zoo_vit() -> dict:
    """(b) ViT-B/16 at 224 px on fake CIFAR: 10 steps; its 197 rows take
    the reference attention (12 per forward), K1 never; fp32 logits on the
    card within 1e-3 of the CPU forward."""
    import dataclasses

    import torch

    from ray_lightning_tpu_torch.models.vit import (
        ViTClassifier,
        ViTConfig,
        vit_forward,
    )

    cfg = ViTConfig(**ZOO_VIT)
    n, B = ZOO_VIT_STEPS, 32
    module = ViTClassifier(cfg, batch_size=B, n_train=2 * B)
    _, clock, launches, wall = zoo_fit(module, n)
    want = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
            "reference": cfg.n_layer * n}
    print(f"[zoo] vit: {n} steps of ViT-B/16 (B={B}, 224 px, "
          f"{cfg.n_patches + 1} rows, bf16) in {wall:.3f} s; launches "
          f"{json.dumps(launches)}; losses {clock.losses}")
    if launches != want:
        fail(f"zoo vit: launches {launches} != {want}")
    run = zoo_summary(clock, B, "images")
    x = module._prep(torch.from_numpy(module._fake(2, seed=3).arrays[0])
                     .cuda())
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    run["fp32_logits_card_vs_cpu"] = zoo_cpu_logits(
        lambda p, im: vit_forward(p, im, cfg32), module.params, x)
    print(f"[zoo] vit {json.dumps(run)} on {card_line()}")
    if not run["fp32_logits_card_vs_cpu"] <= ZOO_LOGIT_TOL:
        fail(f"zoo vit: fp32 logits on the card differ from the CPU "
             f"forward's by {run['fp32_logits_card_vs_cpu']}")
    return run


def zoo_resnet() -> dict:
    """(c) ResNet-18/CIFAR-10 at width 64, fp32, batch 64: 20 SGD steps, no
    flash call, the loss falls; fp32 logits of 2 images on the card within
    1e-3 of the CPU forward."""
    import torch

    from ray_lightning_tpu_torch.models.resnet import CIFARResNet

    n, B = ZOO_RESNET_STEPS, 64
    module = CIFARResNet(batch_size=B, width=64)
    _, clock, launches, wall = zoo_fit(module, n)
    print(f"[zoo] resnet: {n} steps of ResNet-18 (B={B}, 32 px, fp32) in "
          f"{wall:.3f} s; launches {json.dumps(launches)}; losses "
          f"{clock.losses}")
    if any(launches.values()):
        fail(f"zoo resnet: attention calls in a model without attention: "
             f"{launches}")
    if not falls(clock.losses):
        fail(f"zoo resnet: the loss did not fall: {clock.losses}")
    run = zoo_summary(clock, B, "images")
    x = module._prep(torch.from_numpy(module._fake(2, seed=3).arrays[0]).cuda())
    run["fp32_logits_card_vs_cpu"] = zoo_cpu_logits(module._forward,
                                                    module.params, x)
    print(f"[zoo] resnet {json.dumps(run)} on {card_line()}")
    if not run["fp32_logits_card_vs_cpu"] <= ZOO_LOGIT_TOL:
        fail(f"zoo resnet: fp32 logits on the card differ from the CPU "
             f"forward's by {run['fp32_logits_card_vs_cpu']}")
    return run


def zoo_fixtures() -> dict:
    """(d) One epoch each of the XOR and MNIST fixtures on the card, with
    validation: every metric finite."""
    from ray_lightning_tpu_torch.models import MNISTClassifier, XORModule
    from ray_lightning_tpu_torch.trainer import Trainer

    out = {}
    for name, module in (("xor", XORModule()), ("mnist", MNISTClassifier())):
        trainer = Trainer(max_epochs=1, enable_checkpointing=False,
                          enable_model_summary=False, seed=0)
        trainer.fit(module)
        metrics = {k: float(v) for k, v in trainer.callback_metrics.items()}
        if not metrics or not all(math.isfinite(v) for v in metrics.values()):
            fail(f"zoo {name}: metrics {metrics}")
        out[name] = metrics
    print(f"[zoo] fixtures {json.dumps(out)}")
    return out


def bert_row(row: dict) -> dict:
    """A kernel's timing at BERT's attention call, for the kernels line."""
    return {key: row[key] for key in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "tflops")}


def phase_zoo():
    """The model zoo on the card: (a) BERT-base MLM through K1-K3
    non-causal, (b) ViT-B/16, (c) ResNet-18, (d) XOR and MNIST. Returns
    (a)'s launches and its attention call's timing rows."""
    bert = zoo_bert()
    zoo_vit()
    zoo_resnet()
    zoo_fixtures()
    return bert["launches"], bert["rows"]


def _flat_params(tree, prefix=""):
    """(path, tensor) of a parameter tree, in tree order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_flat_params(v, f"{prefix}{k}/"))
        else:
            out.append((prefix + k, v))
    return out


def statistics_median(xs) -> float:
    import statistics

    return statistics.median(xs)


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "ray_lightning_tpu_torch")):
        fail("the ray_lightning_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    def timed_phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        check_engines(name)
        print(f"[time] phase {name}: {time.perf_counter() - t0:.3f} s")
        return out

    tensor_ops = timed_phase("build", phase_build)
    worst, timed = timed_phase("kernels", phase_kernels)
    bwd_worst, bwd_rows = timed_phase("bwd-kernels", phase_bwd_kernels)
    serve_launches, mono_step_s, serve4 = timed_phase("serve", phase_serve)
    chunked_launches = timed_phase("serve-chunked", phase_serve_chunked,
                                   mono_step_s)
    paged_launches = timed_phase("serve-paged", phase_serve_paged)
    spec_launches, draft_row = timed_phase("serve-spec", phase_serve_spec)
    fused_launches = timed_phase("serve-fused", phase_serve_fused, serve4)
    int8_launches = timed_phase("serve-int8", phase_serve_int8, serve4)
    lifecycle_launches = timed_phase("serve-lifecycle", phase_serve_lifecycle)
    fleet_launches, fleet = timed_phase("serve-fleet", phase_serve_fleet,
                                        serve4)
    kvplane_launches = timed_phase("serve-kvplane", phase_serve_kvplane,
                                   fleet)
    recovery_launches = timed_phase("serve-recovery", phase_serve_recovery,
                                    serve4, fleet)
    train_launches, _, yard = timed_phase("train", phase_train)
    dist_launches = timed_phase("train-dist", phase_train_dist, yard)
    gspmd_launches, tp_rows = timed_phase("train-gspmd", phase_train_gspmd,
                                          yard)
    mesh_launches, mesh_row = timed_phase("serve-mesh", phase_serve_mesh,
                                          serve4)
    zoo_launches, bert_rows = timed_phase("zoo", phase_zoo)
    src = "ray_lightning_tpu_torch/ops/csrc/"
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": src + "flash_fwd.cu",
        "replaces": "ray_lightning_tpu/ops/flash_attention.py:29",
        "launches": serve_launches + spec_launches + fused_launches
        + int8_launches + lifecycle_launches + fleet_launches
        + kvplane_launches + recovery_launches + train_launches["flash_fwd"]
        + dist_launches["flash_fwd"] + gspmd_launches["flash_fwd"]
        + mesh_launches + zoo_launches["flash_fwd"],
        "launches_by_path": {"serve": serve_launches,
                             "serve_chunked": chunked_launches,
                             "serve_paged": paged_launches,
                             "serve_spec": spec_launches,
                             "serve_fused": fused_launches,
                             "serve_int8": int8_launches,
                             "serve_lifecycle": lifecycle_launches,
                             "serve_fleet": fleet_launches,
                             "serve_kvplane": kvplane_launches,
                             "serve_recovery": recovery_launches,
                             "train": train_launches["flash_fwd"],
                             "train_dist": dist_launches["flash_fwd"],
                             "train_gspmd": gspmd_launches["flash_fwd"],
                             "serve_mesh": mesh_launches,
                             "train_bert": zoo_launches["flash_fwd"]},
        "max_abs_err": worst["bfloat16"],
        "max_abs_err_fp32": worst["float32"],
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"],
        "library_ms": timed["library_ms"],
        "tflops": timed["tflops"],
        "sass_tensor_core_instructions": tensor_ops["flash_fwd"],
        "host_us_s16": timed["host_us_s16"],
        "shape": [1, timed["S"], 12, 64],
        "train": {key: bwd_rows["flash_fwd"][key]
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "tflops")},
        "train_tp": tp_rows["flash_fwd"],
        "serve_spec": draft_row,
        "serve_tp": mesh_row,
        "train_bert": bert_row(bert_rows["flash_fwd"]),
    }]
    for name, line in (("flash_bwd_dkv", 189), ("flash_bwd_dq", 254)):
        row = bwd_rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + "flash_bwd.cu",
            "replaces": f"ray_lightning_tpu/ops/flash_attention.py:{line}",
            "launches": (train_launches[name] + dist_launches[name]
                         + gspmd_launches[name] + zoo_launches[name]),
            "launches_by_path": {"train": train_launches[name],
                                 "train_dist": dist_launches[name],
                                 "train_gspmd": gspmd_launches[name],
                                 "train_bert": zoo_launches[name]},
            "max_abs_err": bwd_worst["bfloat16"],
            "max_abs_err_fp32": bwd_worst["float32"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "tflops": row["tflops"],
            "sass_tensor_core_instructions": tensor_ops[name],
            "shape": [8, 1024, 12, 64],
            "train_tp": tp_rows[name],
            "train_bert": bert_row(bert_rows[name]),
        })
    print(json.dumps({"kernels": kernels}))
    print(f"[card] {card_line()}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the repository root (it imports ``src/repro_torch`` beside this
file). It needs one CUDA card and exits non-zero without one, or without
the package, before printing any result. It imports nothing of JAX and
nothing of the JAX package `repro`.

Four paths of the paper's GCN (``coin_gcn``) run at the widths of Nell
(Table I: 65,755 nodes, 5,414 → 16 → 210, 4-bit fake quant) with the
blocked (bsr) backend: full-graph inference, full-graph training, and
sharded (halo) inference and training over 4 ranks, flat and as 2 pods ×
2 ranks (the hierarchical exchange; its inference also on the pod map the
autotuner chooses), and the elastic re-plan after a model-degree halving.
The forward of each unsharded layer
runs the hand-written CUDA kernels of `repro_torch.kernels.fused_gcn` (K2):
layer 1 feature-first (``k2_ff_transform`` then ``k2_ff_aggregate``),
layer 2 aggregation-first (``k2_af_layer``). The backward of layer 2
recomputes Ã·h1 through `repro_torch.kernels.bsr_spmm` (K1,
``k1_bsr_spmm``). The sharded forward runs K1 on each rank's
``[local ‖ halo]`` table for layer 1 and K2's aggregation-first kernel for
layer 2 — under the bf16 wire its bf16-operand instantiation
(``k2_af_layer_bf16``: fp32 tiles, bf16 table, fp32 W). Sharded training
runs the exchange's backward (a reduce-scatter through the group) and,
in layer 2's backward, K1 on the same table — under the bf16 wire its
bf16 instantiation (``k1_bsr_spmm_bf16``, the running sum rounded to
bf16 per tile as the TPU kernel does). Weights are random, from a seed.

The same model serves node queries at Nell (`GraphBatcher`: sampled
2-hop blocks, the hot-neighbor cache, plain torch on the card) while the
graph mutates, and the sharded bsr forward and training follow a mutating
graph: every rank keeps its own `DeltaPlanner` replica and its own rank
tables, tile-patched or rebuilt per delta, with K1 and K2 on them.

The other GNN families run next at their configs' full widths, with no
hand-written kernel on their paths (none exists in the reference's: they
are segment sums, scatter max / min and matmuls): PNA (4 layers, d 75)
and EGNN (4 layers, d 64) train on a sampled block of a Reddit-sized
graph and serve node queries on it through `GraphBatcher`; GraphCast
(d 512, n_vars 227; depth cut 16 → 8) trains on its R6 icosphere mesh;
EquiformerV2 (12 layers, 128 channels, l_max 6, m_max 2, 8 heads; nothing
cut) trains on the molecule batch and at Cora's size and runs its forward
at the sampled block; and PNA, EGNN and GraphCast run over Nell's halo
plan on 4 ranks.

A fifth path, DeepFM (arXiv:1703.04247) at its full widths (39 fields,
embed_dim 10, MLP 400-400-400, 1,000,000 rows per field: a 39 M × 10
table), serves, retrieves and trains with its FM term in the CUDA kernel of
`repro_torch.kernels.fm_interaction` (K3, ``k3_fm_interaction``).

A sixth path, gemma3-12b at its full widths (48 layers, d_model 3,840, 16
heads over 8 kv heads of 240, d_ff 15,360, vocab 262,144; 11.62 B fp32
parameters, 46.5 GB; nothing cut), serves: prefill with every layer's
causal / sliding-window attention in the CUDA kernel of
`repro_torch.kernels.flash_attention` (K4, ``k4_flash_attention``), then
KV-cache decode through `ContinuousBatcher`, which never reaches K4. The
same widths cut to 6 layers (one 5 local : 1 global period) train: K4 in
every layer's forward, its gradient `flash_attention_vjp` (torch ops: the
reference has no backward kernel), AdamW. A seventh path, the MoE LM
olmoe-1b-7b (16 layers, d_model 2,048, 64 experts top-8; 6.82 B fp32
parameters, 27.3 GB; nothing cut), serves — prefill with K4 at d 128 in
every layer, KV-cache decode — and trains with its depth cut to 4 layers.
Then the sharded LM and DeepFM (`repro_torch.launch.steps.build_cell` on
a `Grid`, `repro_torch.launch.shardings`): one group of 4 ranks sharing
the card (gloo) serves gemma3-12b (tensor parallel, 1 × 4, 6 of its 48
layers) and
moonshot-v1-16b-a3b (expert parallel, full width, 6 of its 48 layers)
in bf16 with K4's bf16 body, decodes
granite-34b (8 layers) against a sequence-sharded cache, trains gemma3-12b
(6 layers, fp32) and serves, retrieves and trains DeepFM on 2 × 2.
Last, the dry run (`repro_torch.launch.dryrun`): two subprocesses with no
card visible, started beside the sharded phase's group, trace one rank of
each of its cells on meta tensors in a fake process group of the 16 × 16
and the 2 × 16 × 16 grid; beside them one group of 4 ranks on the card runs a train step
of fourteen GNN cells at full_graph_sm (halo flat with the three wires,
hierarchical 2 × 1 × 2, broadcast; PNA, EGNN, GraphCast, EquiformerV2; coin_gcn
``+opt`` on the bsr backend, whose K1 launches count in the ``kernels``
line) and holds every FLOP and collective byte it counts against the meta
run of the same cell. The same group then runs the hand-built cells of the
§Perf hillclimb (`repro_torch.launch.hillclimb`): granite-34b's eight
accumulated micro-batches (2 of 88 layers, 8 × 4,096, bf16, K4 on the
forward), PNA's halo cell in fp32, bf16 compute, bf16 wire and float64 at
full_graph_sm, and gemma3-12b's uniform and two-stack decodes (12 of 48
layers, a 32,768-slot cache split by sequence); its host records (the
four targets on 16 × 16) run in subprocesses started when the delta
phase ends, beside the GNN, DeepFM and LM phases. Work of the GNN phases
that needs no card time (their graph, gnn_train's host runs, gnn_serve's
engines) runs in a thread beside the delta phase's group.

Phases, one JSON line each; any failed check ends the run with exit code 1:

  build    compile the kernels from src/repro_torch/kernels/csrc (nvcc); the
           geometry mirrors of kernels/*.py against the C exports (K2's
           shared memory, the transform's grid and shared memory, K3's tile,
           K4's tiles); tensor-core instructions in the SASS of K4's bodies
           and of the transform's three instantiations (only the all-bf16
           one may have them, and must)
  data     make_dataset("nell") → symmetrize, self-loops, sym-norm weights →
           locality_block_order → blocked_adjacency → the card
  plan     partition_graph(k=4, bfs, refine) → get_halo_plan on the same
           graph; the plan's sizes and both table forms' shapes, printed
           before any tile of them exists
  kernels  each kernel against its plain PyTorch version on the card at
           Nell's layer shapes: relu on and off, NaN-poisoned padding tiles,
           an empty block-row, the 91-row tail block; K1 also on a
           rectangular Z with extra source block-rows; at rank 0's halo
           shapes K1 and fp32 ``k2_af_layer`` over its [local ‖ halo]
           table, K1 over its interior and boundary tables (the split
           pair), and K2's and K1's bf16 instantiations (K1's: within one
           bf16 step of the largest value, ≥ 99 % bit-equal, also with
           NaN-poisoned padding and an emptied block-row); the split
           schedule: K1, both K2 aggregations and the two bf16
           instantiations of the halo path over a skewed table (one
           block-row of 300 tiles among rows of 1–3, an empty row, NaN
           padding) at Nell's 16-wide rows, and the same call twice giving
           the same bits at Nell's and rank 0's shapes (also the
           transform's three instantiations); the all-bf16 transform within
           one bf16 step of the largest value and ≥ 99 % bit-equal
  main     inference: gcn_forward(backend="bsr") three times under
           inference_mode with the launch counts zeroed just before and read
           just after; the quant-off logits against the segment (index_add_)
           path on the card, the quant-on argmax agreement, the test accuracy
  train    training: one quant-off gcn_loss gradient with bsr and with
           segment; a Trainer taking five AdamW steps, quant on, with the
           launch counts zeroed just before and read just after (one launch
           of each kernel per step); five quant-off steps with bsr and with
           segment, loss against loss
  times    CUDA-event medians (the transform's rows: device_ms, calls
           queued behind a spin kernel, the host's launch left out, with
           the one-call event median beside as call_ms): each kernel, its
           plain version, the library
           call where one computes the same function (K1's: a
           torch.sparse_bsr_tensor product, checked first), for K2's two
           aggregations the composition of library calls that computes
           theirs (relu(addmm(b, bsr, z)), relu(addmm(b, bsr @ x, w))),
           each ragged kernel's split (grid, blocks that take tiles, tiles
           per block: largest and mean; from `ragged_split`, the numpy
           mirror of the kernel's schedule, on this run's lens), the whole
           forward, the backward's torch parts; host-clock medians of the
           training step;
           peak device memory; then ``ragged_compiler``: each ragged
           instantiation's registers, local memory (spills) and blocks per
           SM; ``times_rank``: K2's and K1's bf16 instantiations at rank 0's
           shapes; ``dense_compiler``: each transform instantiation's
           registers, spills, blocks per SM and grid
  profile  torch.profiler over three training steps (bsr, quant on): device
           time by kernel and the device's idle share of the window
  af_wide  K2's aggregation-first kernel past one chunk of F_in on Nell's
           table at F_out = 128: F_in 241, 1,433 (Cora's width) and 9,029
           (the reference's widest at 128), every operand mode against its
           plain version (fp32 2e-5 of max, bf16 5e-2), the same bits on two
           calls, ms, bound, registers and spills; F_in 9,030 raises the
           reference's error
  halo     the parent frees the card, then 4 ranks on cuda:0 in one gloo
           group (the wire goes through the host; NCCL takes one rank per
           card) each run gcn_forward on their block: (a) combined table,
           fp32 wire; (b) bf16 wire; (c) split tables; (d) int8 wire;
           (e) quant on, bf16 wire, bsr and segment. Gathered and restored
           logits against the unsharded bsr forward ((e): bsr against
           segment, argmax agreement with ties), launches and wire rows
           per rank, forward and exchange times per rank after a barrier
           (4 ranks share one card: not a multi-card time), peak memory
  halo_train  in the same group, after the forwards: five AdamW steps
           (lr 1e-3) of every rank's Trainer on the sharded loss
           (`halo_loss`) in each of (t1) combined table, fp32 wire; (t2)
           bf16 wire; (t3) split tables; (t4) quant on, bf16 wire, bsr and
           segment; the training mask is the train phase's node set. The
           first gradients and the losses of (t1), (t3) against the train
           phase's unsharded bsr ones (1e-4), (t2)'s gradients at the bf16
           tolerance (5e-2) against the unsharded ones with the logits
           rounded to bf16 (the fused bf16 layer's output, whose rounding
           and its cotangent's move the bias gradient by up to ~6 % of its
           largest entry), (t4) bsr against segment with its logits rounded
           alike; launches per step
           counted from zero just before the steps and read just after;
           wire rows per step (forward and backward exchanges); step ms,
           one exchange's backward ms and peak memory per rank; then
           `overlap_timeline` on the group (rank 0's trace)
  hier     the same partition as 2 pods × 2 ranks on cuda:0 (gloo), bsr:
           (h1) fp32 / bf16 / int8 wire forwards against their flat twins
           and the unsharded forward; (h2) wire rows per rank per phase
           against the plan, inter-pod rows crossing below the flat
           schedule's; (h3) the sharded loss's gradient against the train
           phase's; (h4) three AdamW steps against its losses (rank 0
           checkpoints the last); launches per rank, ms per exchange phase,
           step ms and peak memory per rank; `overlap_timeline` on the
           2 × 2 groups
  autotune  placement (`repro_torch.core.autotune`): (a) the CLI
           `repro_torch.launch.autotune` at its defaults (16,384 nodes, k
           32, 2 pods) on the host: exit code 0, no predicted field off its
           measured twin, the chosen config, the inter-pod crossing rows
           default → tuned, host seconds; (b) the halo phase's partition
           of Nell as 2 pods: `map_parts_to_pods`, the tuned plan beside the
           default one, no more crossing rows on the tuned one,
           `exchange_accounting`'s predicted fields equal to the measured
           ones on both (fp32, and int8 with overlap, at the exchanged
           width 16), `autotune_config`'s choice and history; (c) the hier
           phase's group, after its own work, runs the 2 × 2 bsr fp32
           forward on the tuned plan (K1 and K2 af on every rank): its
           logits against the default plan's and the unsharded forward
           (1e-4 of max |logit|), the wire rows per rank per phase against
           the tuned plan's, launches; forward and per-phase exchange ms of
           both maps (no gate: one card, gloo); (d) not gated: the H100
           planner's compute and HBM terms for unsharded Nell beside the
           measured quant-off forward, and the inputs of
           `BACKEND_EFFICIENCY` (one fp32 aggregation at F = 16 and 210
           through K1 and through the segment path, measured before the
           halo phase while the unsharded table is on the card)
  elastic  elastic_replan: a pure resize (8 healthy ranks) keeps the cached
           plan, 0 evictions, the same object; a halving to 2 ranks evicts,
           the partition is rebuilt at k = 2, and a 2-rank group restores the
           hier phase's checkpoint: its first loss against the unsharded
           loss at the checkpointed parameters (1e-4)
  obs      the two overlap traces (a wire span encloses an interior span,
           on the wire track), and torch_profiler_trace around K1 and K2
           launches: one trace file that names the kernels
  serve_graph  `GraphBatcher` on the card over the whole Nell graph with the
           reference serve CLI's defaults (batch_seeds 8, fanout 4, cache
           256, 4 parts; quant forced off): 512 hot_query_stream queries in
           waves of 32, a cache-off twin serving the same stream; halfway
           the CLI's churn burst (8 deltas of 2 % of the edges) to both
           engines and to a mirrored DeltaPlanner under a RelocalizePolicy
           (threshold 1.30 from this burst's drift readings) whose fire the
           engines adopt. Cache on = cache off (1e-5 of max |logit|) before
           and after the burst, and = a fresh cache-less engine on the
           mutated graph; strictly fewer nodes + edges sampled per query
           with the cache; one forward shape per engine; the policy fired.
           p50/p99, queries/s, nodes and edges per query (on, off), hit
           rate, residents, rows and bytes saved, each delta's
           apply_graph_delta ms with residents dropped, the planner's
           apply_ms, the drift readings and fires; the profiler's device
           share of one wave
  delta    (prepared while the unsharded table is still on the card) one
           DeltaPlanner replica makes the script — a tile-patch delta (64
           deletes, 64 inserts inside devices), a structural one (the flat
           pad grows), rewiring deltas (the reference test's form at 1 % of
           E) under a RelocalizePolicy (threshold 1.20) until it fires, one
           more, then compact — and the data phase's global table, patched
           through the same deltas (delta_update_blocked_adjacency), gives
           the unsharded bsr forward at every stage and the AdamW losses.
           Then the 4 ranks (gloo, one card), each with its own replica, flat
           and 2 × 2 plans and its own rank tables (its tiles, every rank's
           index), run at every stage the bsr forward of both schedules
           against the unsharded one (1e-4 of max |logit|), launches counted
           from zero; rank 0 holds its tables against fresh builds (tile for
           tile; after compact array-equal at the shared width) and runs
           K1 and K2 on its patched table against their plain versions and
           with NaN padding; 3 AdamW steps after the tile-patch delta and
           3 after the structural one against the unsharded losses (1e-4);
           the plan checksums of all ranks and the replica agree; the
           executed tiles fall at the fire; the blocks moved by
           relocate_state_tree are bit-exact. Apply, patch, rebuild and
           relocalize ms per rank, forward ms per stage and schedule, step
           ms before and after, peak memory per rank, table host bytes
  gnn_data  citation_like(232,965, 114,615,892, 602, 41, positions) — the
           minibatch_lg shape — and NeighborSampler(fanout (15, 10)): one
           block of 1,024 seeds (≤ 169,984 nodes, 168,960 edges); host s
  gnn_train  one line a model. pna and egnn at make_config(minibatch_lg)
           on the block, the loss on the seed rows (`_gnn_loss_fn`,
           n_loss_nodes), the edge mask passed; graphcast at
           make_config(None) with n_layers 16 → 8 (reduced) on
           random_graph at icosphere_sizes(6), positional edge features,
           a residual target. Each: the forward and first gradient in fp32
           on the card against the same in float64 on the card (graphcast's
           with remat) within max(1e-4, 4 × the host's own fp32 error on
           the same inputs) — pna and egnn also float64 card against
           float64 host within 1e-6 —; five AdamW steps (lr 1e-3) of a
           Trainer: finite losses, the last below the first; step ms, the
           forward / backward / optimizer split, peak memory, the
           profiler's idle share and top kernels over one step; graphcast
           also its FLOPs, bound and rate
  gnn_serve  pna and egnn through GraphBatcher on the gnn_data graph with
           the serve CLI's defaults (8 seeds, fanout 4, cache off), 256
           hot_query_stream queries each after one warm-up forward: p50,
           p99, queries/s, ms a micro-batch, nodes and edges per query,
           one forward shape; every micro-batch's served rows against the
           same packed micro-batch through the engine's forward on the
           host in float64 (the same rule as gnn_train); the profiler's
           idle share over 32 more queries
  equiformer_train  one line a shape, make_config(shape) at full width:
           molecule (molecule_batch: 128 × 30 atoms, 64 edges each) and
           full_graph_sm (citation_like at Cora's size with positions, d_in
           1,433, d_out 7), every node's seeded regression target. On a
           slice (the first 2 molecules; Cora's nodes < 200): fp32 on the
           card against float64 on the card (forward, first loss and every
           gradient leaf within max(1e-4, 4 × the host's fp32 error against
           the same float64) of max; the logits' last bias, whose gradient
           the softmax cancels, against the largest leaf's max), float64
           card against float64 host within 1e-6; then 5 AdamW steps of
           a Trainer on the whole batch, the split, peak memory, the
           profile of one step, TFLOP/s by the reference's _gnn_flops
  equiformer_equivariance  the same two graphs with their positions
           rotated by a seeded rotation and shifted: the output within
           1e-4 of max (predicted in PERF.md before the first run)
  equiformer_chunk  edge_chunk 1,024 on the molecule batch (8 chunks)
           against the unchunked messages, within 1e-5 of max; both
           forwards' ms
  equiformer_block  make_config(minibatch_lg) (d_in 602, d_out 41) on
           gnn_data's sampled block, edge_chunk by the cell's big-edge rule
           (ceil(114,615,892 / 64) ≥ the block's 168,960 edges: one chunk),
           forward only: the seed rows against float64 (in chunks of
           16,384 edges) within 1e-4, ms, peak memory, idle share
  gnn_halo  the halo phase's Nell plan, 4 ranks (gloo, one card): pna,
           egnn and graphcast at full width (d_in 5,414, d_out 210,
           positions seeded per node) with the fp32 and the bf16 wire,
           against the unsharded forward on the card: fp32 within 1e-3 of
           max; bf16 pna at 5e-2 max-abs and 1e-2 relative L2 (the
           reference's gate), egnn and graphcast at 5e-2 of max and 1e-2
           relative L2; exchanges, wire bytes a layer, forward and
           exchange ms per rank
  gnn_launches  K1–K4 counted from zero before gnn_data and read after
           gnn_halo, in the parent and in every rank (the EquiformerV2
           phases included): all zero

  deepfm_kernels  (d1) K3 against its plain version on the card at the
           recsys shapes serve_p99 (512), train_batch (65,536) and
           serve_bulk (262,144) × 39 × 10 fp32, an odd B (1,000), and bf16
           at train_batch (one bf16 step of the largest value, ≥ 99 %
           bit-equal), each instantiation twice giving the same bits;
           device_ms times beside the bound (call_ms beside), each shape's
           tile, and each body's registers, spills and blocks per SM
  deepfm_serve  (d2) deepfm_init at the full widths (a seeded CUDA
           generator), then deepfm_forward at serve_p99 (one warm-up, five
           requests, p50) and at serve_bulk, with the launch counts zeroed
           just before and read just after; the logits against the same
           forward with the FM term computed by the plain version (1e-5 of
           max |logit|)
  deepfm_retrieval  (d3) deepfm_retrieval: 1 query × 1,000,000 candidates
           (field 0's rows), finite scores, CUDA-event time
  deepfm_train  (d4) the first gradients of deepfm_loss with K3 against
           those with the plain FM term (1e-4 of each parameter's largest
           entry); five AdamW steps (lr 1e-3) of a Trainer at train_batch
           on the click_batch_fn stream with the launch counts zeroed just
           before and read just after; step time, peak memory, and the
           device's idle share from torch.profiler over three steps
  dispatch  the host µs a call of K3 (serve_p99) and of K1 (one block row)
           costs through its `torch.library` custom op and through the
           kernel's own module, launched back to back; their difference is
           what the custom op adds to every main-path call

  lm_kernels  (l1) K4 against its plain version on the card at gemma3-12b's
           attention shape for one sequence (16 query heads over 8 kv
           heads, d 240) at S = 4,096 with the global (2³⁰) and the local
           (1,024) window, an odd S (1,000), S under one tile (40),
           window 0 and the bidirectional mask; grouped kv heads against
           the same call on k and v expanded (bit-equal); bf16 at both
           windows, an odd S and S under one tile (one bf16 step of the
           largest value, ≥ 99 % bit-equal) and grouped against expanded
           (bit-equal); CUDA-event times of K4, the plain version and SDPA
           (the library yardstick, never called by the port) beside the
           bound, fp32 and bf16 at both windows, and K4 alone at 32,768;
           each body's registers, local memory (spills) and blocks per SM
           as the compiler gave them (the build line also counts the
           tensor-core instructions in each body's SASS: the bf16 body
           must have them, the fp32 body none)
  lm_init  lm_init(FULL) from a seeded CUDA generator: parameter count and
           bytes
  lm_prefill  (l2) lm_prefill at B = 1, S = 4,096 (token_batch_fn): one
           warm-up and three timed runs with the launch counts zeroed just
           before and read just after (48 launches each: 40 local, 8
           global); the logits against the same prefill with the plain
           attention in every layer (1e-4 of max |logit|, same argmax);
           peak memory; the profiler's idle share over one prefill
  lm_decode  (l3) ContinuousBatcher(4 slots, max_len 256) serving 8
           requests (prompts of 16–64 tokens, 16 new tokens each) with the
           launch counts zeroed just before and read just after (no K4
           launch); engine-step times; two requests' logits at their last
           prompt position against lm_prefill's (1e-3 of max |logit|) and
           their first token against its argmax; peak memory; the
           profiler's device time over three decode steps of every slot
  lm_train  the serving weights freed, gemma3-12b's widths cut to 6 layers
           (reduced: n_layers 48 → 6), B 2 × S 2,048 from token_batch_fn,
           the same batch every step: (a) one lm_loss gradient at B 1 with
           K4 in the forward and flash_attention_vjp behind it against the
           same loss with the plain attention and autograd (1e-4 of each
           leaf's largest |g|); K4 against its plain version at this path's
           shapes (32 query / 16 kv heads × 2,048 × 240, both windows);
           (b) five AdamW steps (lr 1e-3) of a Trainer with the launch
           counts zeroed just before and read just after: finite losses,
           the last below the first, 6 launches a step (5 at window 1,024,
           1 global); (c) one more step's forward, backward and update
           timed apart: 6 launches after the forward and none added by the
           backward; (d) host-clock step times, the attention backward's
           ms a layer against K4's forward (CUDA events), peak memory, the
           profiler's device time by kernel and idle share over 2 steps
  moe_serve  lm_init(olmoe-1b-7b FULL): parameter count; (a) teacher-forced
           decode of 2 × 64 tokens against lm_forward on the same tokens
           (2e-4 of max |logit|; both drop-free, T ≤ 512); K4 against its
           plain version at 16 heads × 4,096 × 128; (b) lm_prefill at
           1 × 4,096, one warm-up and three CUDA-event-timed runs with the
           launch counts zeroed just before and read just after (16 global
           launches each), the (token, expert) pairs capacity (640) drops
           in each layer
  moe_decode  (c) lm_decode's batcher checks on olmoe-1b-7b: step p50, the
           profiler's idle share, no K4 launch
  moe_train  (d) olmoe-1b-7b's widths cut to 4 layers (reduced: n_layers
           16 → 4), B 2 × S 2,048, five AdamW steps with the launch counts
           zeroed just before and read just after (4 a step): finite
           losses, the last below the first; aux and dropped pairs a step,
           step ms, peak memory

  sharded_kernels  K4 (fp32 and bf16) and K3 against their plain versions
           at the shapes one rank of the group gives them (gemma3's 4 / 2
           heads × 4,096 × 240 bf16 at both windows, moonshot's 4 / 4 × 4,096
           × 128 bf16, the training rank's 8 / 4 × 2,048 × 240 fp32, the
           hillclimb's granite-34b micro-batch, 12 / 1 (MQA) × 4,096 × 128
           bf16, K3 at 256 / 32,768 / 131,072 × 39 × 10), with K4's, the plain version's
           and SDPA's times beside the bound (the parent alone on the card)
  lm_tp, moe_ep, lm_seq, lm_tp_train, deepfm_sharded  first every phase's
           unsharded counterpart alone (the same cells on a 1 × 1 grid, the
           same weights drawn block by block from the seed; the host keeps
           the logits, gradients and losses), then one group of 4 ranks on
           the card (gloo) runs every phase's cells (`Cell.bind` on the
           rank's data and model groups). lm_tp: gemma3-12b bf16 at full
           width cut to 6 layers (reduced: n_layers 48 → 6, the time
           limit) on 1 × 4, prefill 1 × 4,096 (counted: 6 K4 bf16 launches
           a prefill a rank, 5 local, 1 global) and 4 decode
           steps at B 4 on a kv-head-sharded 4,096-slot cache, held against
           the unsharded run (5e-2 of max |logit|, the same argmax up to
           ties within it); moe_ep: moonshot-v1-16b-a3b FULL bf16, 16
           experts a rank, cut to 6 layers (the time limit): each MoE
           layer alone on one seeded
           4,096-token input whose tokens share a direction (so capacity
           drops pairs), expert parallel against unsharded (the same
           expert ids and dropped pairs in every layer, the output within
           5e-2 of its largest entry), then the model as lm_tp (end to end a
           decode row's logits are held only where its routing matched the
           unsharded run's: bf16 router logits tie, and a reassociated sum
           flips a tie; the dropped pairs per layer equal to the unsharded
           run's up to the first layer routed differently and, in both runs
           and every layer, to the capacity rule applied to that run's
           routing, with the routing margin); lm_seq:
           granite-34b cut to 8 layers (reduced: n_layers 88 → 8), 4 decode
           steps at B 4 on a seeded 32,768-slot cache sharded by sequence,
           the positions crossing a shard's boundary; lm_tp_train: gemma3-12b
           fp32 cut to 6 layers, B 2 × 2,048: the first gradient of every
           rank's shard within 1e-4 of each leaf's largest entry, then 2
           steps of the cell (AdamW, updating in place; 12 K4 fp32 launches
           a rank), every step's loss within 1e-4 of the unsharded run's;
           deepfm_sharded: DeepFM FULL on 2 × 2: serve 512, bulk 262,144,
           retrieval 1 × 10⁶ (1e-5 of max), the first gradient per leaf
           (1e-4), 2 steps of the cell, every loss within 1e-4 (K3
           launches a rank). Each line: per-rank ms, the collectives a step
           (count, bytes, host ms, share of the step), the card's idle
           share over one profiled step, peak memory per rank, and the
           unsharded run's numbers beside

  dryrun   (a) the host subprocesses' sweep: pna × full_graph_sm, molecule,
           minibatch_lg; equiformer-v2 × full_graph_sm, minibatch_lg (its
           big-edge rule's one chunk); coin_gcn × cora (full_graph_sm's graph) +opt and
           +int8; gemma3-12b × train_4k, decode_32k; moonshot-v1-16b-a3b ×
           train_4k +opt; deepfm × train_batch, retrieval_cand, each on
           16 × 16 and 2 × 16 × 16, every record OK (FLOPs, collective bytes
           by kind, the dominant term, trace seconds); (b) one 4-rank gloo
           group: each cell's train step, its FLOPs (FlopCounterMode) and
           collectives by kind (count, bytes in, result bytes) equal to the
           meta run's of the same cell as the same rank, exactly; (c) each
           fp32-wire loss, gradient and updated parameter (in fp32 those
           whose k = 1 gradient is not rounding noise: AdamW's first step
           moves a parameter by lr·sign(g); in float64 every one;
           EquiformerV2's logits' last bias, whose gradient the softmax
           cancels, against the largest leaf's max, its parameters unheld)
           against the same cell at k = 1 on the card within 1e-4 (PNA's
           gradient and parameters in float64, its fp32 loss beside;
           EquiformerV2's cells in float64), the
           bf16 / int8 losses within 1 % of fp32's, halo below broadcast in
           all-gather and total bytes; (d) the meta counts of the lm_tp
           prefill and of the deepfm_sharded cells equal to what those
           phases counted (per kind; STATS' count and bytes)
  hillclimb the hillclimb's cells on the dry run's 4 ranks (1 × 4): (a)
           each cell's FLOPs and collectives by kind equal to the meta
           run's as the same rank, exactly; (b) t2-b's loss within 1e-2
           and each gradient leaf within 5e-2 of its max against one step
           of the remat cell on the same 8 rows; (c) t4-a's and t4-b's
           logits within 5e-2 of the max and with the same argmax as the
           uniform decode of the same cache and token, t4-b's ring slot
           pos mod W of the first local layer equal bit for bit to the
           uniform cache's new k / v at pos (the others within 5e-2); (d)
           t3-b's and t3-c's losses within 1 % of the fp32 cell's, the
           float64 cell's loss and gradient within 1e-4 of its four
           blocks run in one process on the card; (e) t3-c's halo
           all-gather result bytes half the fp32 cell's; every host record
           OK (t1, t2, t4 at production shapes, t3 at full_graph_sm, on
           16 × 16), t3-a above t3-baseline in collective bytes, t2-a
           below t2-baseline in peak bytes, t2-c equal to t2-a

then the card's name and power limit (nvidia-smi), the ``{"kernels": [...]}``
line, and as the last line ``{"ok": true, "device": {...}}``. A kernel's
``launches`` there is its count over the main-path runs (inference
forwards, training steps, the halo forwards and the halo training steps
of all ranks, flat and hierarchical, the forwards on the autotuned pod
map, and the delta phase's forwards and steps of all ranks; for K3 the DeepFM serving requests and training steps; for
K4 the LM prefills, the batcher's decode steps, gemma3's training steps
(``launches_lm_train``) and olmoe's prefills, decode and training steps
(``launches_moe``), and the 4 ranks' counted runs of the sharded phases
(``launches_lm_tp``, ``launches_moe_ep``, ``launches_lm_seq``,
``launches_lm_tp_train``; K3's ``launches_deepfm_sharded``), and the
hillclimb's cells on the dry run's 4 ranks (``launches_hillclimb``: the
granite forwards, remat's recompute included); K1's also
the dry run's 4-rank steps, ``launches_dryrun``), each counted
with the counts zeroed just before and read just after. K4's counts are forward launches only: its backward,
`flash_attention_vjp`, launches no K4.
"""
from __future__ import annotations

import atexit
import concurrent.futures
import dataclasses
import gc
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

DATASET = "nell"
SEED = 0
PASSES = 3                     # main-path forwards
TRAIN_STEPS = 5                # Trainer steps of the train phase
KERNEL_RTOL = 1e-4             # kernel vs plain: max |diff| ≤ KERNEL_RTOL · max |plain|
GRAD_RTOL = 1e-4               # bsr vs segment gradients, same rule per parameter
LOSS_RTOL = 1e-4               # bsr vs segment quant-off losses, relative, every step
LOGIT_RTOL = 1e-4              # quant-off logits, bsr kernels vs segment path, same rule
ARGMAX_AGREEMENT = 0.999       # quant on: a 4-bit bucket may flip on a rounding difference;
                               # ties within LOGIT_RTOL count as agreement
BF16_KERNEL_RTOL = 1e-2        # a bf16 output: max |diff| ≤ 1e-2 · max |plain|
SPIN_CYCLES, SPIN_MS = 10_000_000, 5.0   # device_ms's spin: 10 M cycles, at least 5 ms at the H100's ≤ 1.98 GHz
SPIN_TRIES = 3                 # device_ms: spins, each longer than the last, before the host is judged too slow
PROFILE_TRIES = 3              # obs: profiler traces of K1 and K2 taken before one that names no card kernel fails
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM data sheet, fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM data sheet, dense bf16 tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_gcn_kernels.cuh"
XW_SOURCE = "src/repro_torch/kernels/csrc/xw_kernel.cuh"
REPLACES = {
    "k2_ff_transform": "src/repro/kernels/fused_gcn.py:45",
    "k2_ff_aggregate": "src/repro/kernels/fused_gcn.py:45",
    "k2_af_layer": "src/repro/kernels/fused_gcn.py:70",
    "k1_bsr_spmm": "src/repro/kernels/bsr_spmm.py:87",
}
REPLACES.update({f"{k}{sfx}": REPLACES[k] for sfx in ("_bf16", "_bf16_all") for k in list(REPLACES)})
K2 = ("k2_ff_transform", "k2_ff_aggregate", "k2_af_layer")
FP32_KERNELS = K2 + ("k1_bsr_spmm",)
# Fake quant's launches in one 4-bit GCN forward (quant on, fp32 h): per layer, the weights' max pass, the
# activations' three digit passes (99.9th percentile) and a quantize pass each. Training's backward adds none.
FQ_LAUNCHES_PER_FORWARD = {"fq_select_pass": 6, "fq_max_pass": 2, "fq_quantize": 4}
# (vals, x, w) dtypes of K2's bf16 instantiations, by launch-name suffix.
BF16_COMBOS = {"_bf16": (torch.float32, torch.bfloat16, torch.float32),
               "_bf16_all": (torch.bfloat16, torch.bfloat16, torch.bfloat16)}
# (vals, Z) dtypes of K1's bf16 instantiations, by launch-name suffix.
K1_BF16_COMBOS = {"_bf16": (torch.float32, torch.bfloat16), "_bf16_all": (torch.bfloat16, torch.bfloat16)}
K1_BF16_STEP = 2.0 ** -7       # K1 bf16 vs plain: max |diff| ≤ one bf16 step of max |plain| ...
K1_BF16_BIT_EQUAL = 0.99       # ... and at least 99 % of the elements bit-equal (the sums' order inside
                               # a tile may flip a per-tile rounding)
SKEW_ROWS, SKEW_LONG_ROW = 48, 300   # the kernels phase's skewed table: one 300-tile block-row among rows of 1–3

K3_SOURCE = "src/repro_torch/kernels/csrc/fm_interaction_kernels.cuh"
REPLACES.update({"k3_fm_interaction": "src/repro/kernels/fm_interaction.py:29",
                 "k3_fm_interaction_bf16": "src/repro/kernels/fm_interaction.py:29"})
DEEPFM_REQUESTS = 5            # timed serve_p99 requests, after one warm-up
DEEPFM_TRAIN_STEPS = 5         # Trainer steps at train_batch
DEEPFM_LR = 1e-3
DEEPFM_LOGIT_RTOL = 1e-5       # (d2): K3 logits vs the plain FM term's, · max |logit|
DEEPFM_GRAD_RTOL = 1e-4        # (d4): first gradients, K3 vs the plain FM term, · max per parameter

K4_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_kernels.cuh"
REPLACES.update({"k4_flash_attention": "src/repro/kernels/flash_attention.py:70",
                 "k4_flash_attention_bf16": "src/repro/kernels/flash_attention.py:70"})
LM_SEQ = 4096                  # (l1) attention shape and (l2) prefill length, batch 1
LM_LONG_SEQ = 32_768           # (l1) prefill_32k's per-sequence length, K4 timed alone
LM_PREFILL_REPS = 3            # (l2) timed prefills after one warm-up
LM_LOGIT_RTOL = 1e-4           # (l2) K4 prefill logits vs the plain attention's, · max |logit|
LM_SLOTS, LM_MAX_LEN = 4, 256  # (l3) ContinuousBatcher
LM_REQUESTS, LM_NEW_TOKENS = 8, 16
LM_PROMPT_LEN = (16, 64)       # (l3) prompt lengths, inclusive
LM_DECODE_RTOL = 1e-3          # (l3) batcher logits at the last prompt position vs lm_prefill's, · max |logit|:
                               # another summation order (the plain einsum over the cache against K4) and other
                               # cuBLAS shapes (4 rows against the prompt's), through 48 fp32 layers
LM_TRAIN_LAYERS = 6            # lm_train: gemma3-12b's depth cut 48 → 6 (one 5 local : 1 global period), widths whole
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 2, 2048   # lm_train: B × S (+1 token for the labels), the same batch every step
LM_TRAIN_STEPS = 5             # lm_train (b): AdamW steps of a Trainer
LM_TRAIN_LR = 1e-3
LM_TRAIN_GRAD_RTOL = 1e-4      # lm_train (a): K4 + flash_attention_vjp vs the plain attention's autograd, · max per leaf
LM_TRAIN_PROFILE_STEPS = 2     # lm_train (d): steps under torch.profiler
MOE_DECODE_BATCH, MOE_DECODE_LEN = 2, 64   # moe (a): teacher-forced decode against lm_forward (drop-free: T ≤ 512)
MOE_DECODE_RTOL = 2e-4         # moe (a): tests/test_models.py's decode-vs-forward tolerance, · max |logit|
MOE_PREFILL_SEQ = 4096         # moe (b): prefill 1 × 4,096 (capacity 640 a layer)
MOE_TRAIN_LAYERS = 4           # moe (d): olmoe-1b-7b's depth cut 16 → 4 for training, widths whole
MOE_TRAIN_STEPS = 5            # moe (d): AdamW steps at LM_TRAIN_BATCH × LM_TRAIN_SEQ

HALO_K = 4
HALO_REPS = 3                  # timed forwards / exchanges per variant and rank (5 → 3: the script's time limit)
HALO_REPS_REDUCED = {"timed repetitions": f"5 → {HALO_REPS} (the script's time limit)"}
HALO_TIMEOUT_S = 480.0
HALO_LOGIT_RTOL = 1e-4         # (a), (c): fp32 wire vs the unsharded bsr forward, · max |logit|
HALO_BF16_RTOL = 1e-2          # (b): the reference's bf16 bound (tests/test_overlap_halo.py:241-242), · max |logit|
HALO_INT8_ABS = 5e-2           # (d): the reference's int8 bounds (tests/test_overlap_halo.py:243-250):
HALO_INT8_REL_L2 = 1e-2        #      5e-2 max-abs and 1e-2 relative L2
HALO_TRAIN_STEPS = 5           # AdamW steps (lr 1e-3) per halo training variant
HALO_TRAIN_LR = 1e-3
HALO_GRAD_RTOL = 1e-4          # (t1), (t3): first gradients vs the unsharded bsr ones, · max per parameter
HALO_LOSS_RTOL = 1e-4          # (t1), (t3): five-step losses vs the unsharded bsr ones, relative
HALO_BF16_GRAD_RTOL = 5e-2     # (t2) vs unsharded, (t4) bsr vs segment: the reference suite's bf16 tolerance
HALO_QUANT_LOSS_RTOL = 1e-2    # (t4) bsr vs segment losses, relative (bf16 logits of the fused layer)

HIER_PODS = 2                  # hier: the same 4 ranks as 2 pods × 2
HIER_TRAIN_STEPS = 3           # (h4) AdamW steps (lr 1e-3); rank 0 checkpoints the last, for the elastic phase
ELASTIC_HEALTHY = (8, 2)       # elastic: 8 healthy ranks keep the 4 model shards (a pure resize); 2 halve them
AUTOTUNE_CELLS = ((None, False), ("int8", True))   # autotune (b): exchange_accounting's (payload, overlap)
AUTOTUNE_WIDTHS = (16, 210)    # autotune (d): one aggregation per width, K1 and the segment path
AF_WIDE_F_IN = (241, 1433, 9029)   # af_wide: past one chunk; Cora's width (Table I); the reference's widest at 128
AF_WIDE_F_OUT = 128
AF_WIDE_RTOL = 2e-5            # af_wide: fp32 kernel vs plain, · max |plain|
AF_WIDE_BF16_RTOL = 5e-2       # af_wide: bf16 operands vs plain, · max |plain| (the parity contract's bf16 rule)

SERVE_QUERIES, SERVE_WAVE = 512, 32   # serve_graph: hot_query_stream queries, submitted in waves
SERVE_BATCH_SEEDS, SERVE_FANOUT = 8, 4    # the reference serve CLI's defaults
SERVE_CACHE, SERVE_PARTS = 256, 4
SERVE_CHURN_ROUNDS = 8         # the reference CLI's burst: 8 deltas of 2 % of the edges (default_rng(2))
SERVE_RELOCALIZE = dict(threshold=1.30, patience=2, cooldown=3)   # the CLI's patience and cooldown; the
                               # threshold sits inside this burst's drift readings at Nell (1.2613, 1.2966,
                               # 1.3290, 1.3624, ... with no policy armed): the policy fires on the 4th delta
SERVE_LOGIT_RTOL = 1e-5        # cache on vs off, vs a fresh cache-less engine: · max |logit| (the reference's 1e-5)

DELTA_PATCH_OPS = 64           # delta: the tile-patch delta deletes 64 edges and inserts 64 inside devices
DELTA_MEMBERS, DELTA_MAX_EDGES = 200, 2000   # the rewiring burst (the reference test's form at 1 % of E)
DELTA_RELOCALIZE = dict(threshold=1.20, patience=2, cooldown=3)   # the burst's drift readings at Nell:
                               # 1.0851, 1.1113, 1.1390, 1.1721, 1.2287, 1.2541, ...: fires on the 6th delta
DELTA_MAX_BURST = 12
DELTA_TRAIN_STEPS = (3, 3)     # AdamW steps after the tile-patch delta and after the structural one
DELTA_LAUNCHES_PER_FORWARD = {"k1_bsr_spmm": 1, "k2_af_layer": 1}      # per schedule, as HALO_LAUNCHES["a_fp32"]
DELTA_LAUNCHES_PER_STEP = {"k1_bsr_spmm": 2, "k2_af_layer": 1}

GNN_SHAPE = "minibatch_lg"     # gnn_data/_train/_serve: Reddit's size (registry.gnn_shapes), fanout (15, 10)
GNN_BLOCK_SHAPE = (169_984, 168_960)   # a sampled block of 1,024 seeds: at most these nodes and edges
GNN_TRAIN_STEPS = 5            # gnn_train: AdamW steps of a Trainer per model
GNN_HOST_THREADS = 4           # gnn_train's host runs beside the delta group (its 4 ranks take a thread each)
GNN_LR = 1e-3
GNN_GRAPHCAST_LAYERS = 8       # gnn_train: graphcast's depth cut 16 → 8 (at R6, 16 layers' fp32 activations
                               # passed 80 GB: OOM at 75.5 GB allocated in the first forward); widths whole
GNN_HOLD_RTOL = 1e-4           # gnn_train/_serve: fp32 on the card vs float64, · max |·| (gradients: per leaf) ...
GNN_HOLD_FACTOR = 4.0          # ... or within 4× the host's own fp32 error on the same inputs, where the model's
                               # fp32 arithmetic is worse than 1e-4 (PNA's E[x²]−E[x]² std; EGNN): PERF.md §6
GNN_F64_RTOL = 1e-6            # gnn_train: float64 on the card vs float64 on the host (pna, egnn), · max |·|
GNN_SERVE_QUERIES = 256        # gnn_serve: hot_query_stream queries per model
GNN_HALO_REPS = 1              # gnn_halo: timed forwards / exchanges per model, wire and rank (3 → 1: the script's
                               # time limit)
GNN_HALO_GRAPHCAST_LAYERS = 2  # gnn_halo: graphcast's depth cut 16 → 4 → 2: 17 exchanges of 76.5 MB through gloo
                               # made a forward 2.7 s a rank; the script's time limit; widths whole
GNN_HALO_FP32_RTOL = 1e-3      # gnn_halo: fp32 wire vs the unsharded forward, · max |·|
GNN_HALO_BF16_ABS, GNN_HALO_BF16_REL_L2 = 5e-2, 1e-2   # pna, bf16 wire: tests/test_overlap_halo.py:352-385
GNN_HALO_BF16_RTOL = 5e-2      # egnn and graphcast, bf16 wire: · max |·| (with the relative L2 1e-2), the gate
                               # predicted in PERF.md before the first run
EQ_SHAPES = ("molecule", "full_graph_sm")   # equiformer_train: 128 molecules of 30 atoms / 64 edges; Cora's size
EQ_HOST_NODES = {"molecule": 60, "full_graph_sm": 200}   # equiformer_train: the slice the hold runs on (the first
                               # 2 molecules, 128 edges; Cora's nodes < 200 and the 222 edges among them): the
                               # host's fp32 run of the whole batch at full width takes ≈ 36 s, float64 more
EQ_CANCELLED = ("attn/l1/b",)  # the logits' last bias: a constant on every logit of a head, which the softmax
                               # cancels, so its gradient is rounding alone (held against the largest leaf's max)
EQ_EQUIVARIANCE_RTOL = 1e-4    # equiformer_equivariance: rotated + translated positions, · max |out| (predicted
                               # in PERF.md before the first run)
EQ_CHUNK = 1024                # equiformer_chunk: edge_chunk on the molecule batch (8,192 edges: 8 chunks)
EQ_CHUNK_RTOL = 1e-5           # equiformer_chunk: chunked vs unchunked forward, · max |out| (the reference's 1e-5)
EQ_BLOCK_REPS = 1              # equiformer_block: timed forwards after the held one
EQ_BLOCK_FP64_CHUNK = 16_384   # equiformer_block: the float64 reference's edge_chunk (the same sums in chunks: one
                               # float64 chunk of the block's 168,960 edges would pass 80 GB)


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line; ``t_s``: the script's seconds when it ends."""
    print(json.dumps({"phase": phase, **fields, "t_s": round(time.perf_counter() - _T0, 1)}), flush=True)


def require(ok: bool, phase: str, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: phase {phase!r} failed: {what}")


def max_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |out − ref|, max |ref|), NaN in ``out`` counting as infinite."""
    diff = (out - ref).abs().nan_to_num(nan=float("inf"))
    return float(diff.max()), float(ref.abs().max())


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` between CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Milliseconds of one call of ``fn`` on the card, the host's launch time
    left out: a spin kernel holds the stream while the host queues ``reps``
    calls between two CUDA events, so the card runs them back to back;
    elapsed time over ``reps`` (a kernel's time and its launch gap). Unlike
    `cuda_ms`, whose events also hold the host's time to reach the launch
    (some 20 µs through a wrapper), this reads a short kernel's own time.
    A reading counts only if the host queued the calls within 0.8 of the
    spin; if it did not, the spin is lengthened to cover twice the queueing
    seen and the calls are timed again, SPIN_TRIES times in all, and then
    the phase fails."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(SPIN_TRIES):
        spin_ms = SPIN_MS * cycles / SPIN_CYCLES
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if queued_ms < 0.8 * spin_ms:
            return start.elapsed_time(end) / reps
        cycles = int(cycles * max(2.0, 2.0 * queued_ms / spin_ms))
    require(False, "times", f"queueing {reps} calls took {queued_ms:.2f} ms, past 0.8 of the spin's {spin_ms:.1f} ms "
                            f"after {SPIN_TRIES} spins: the card may have waited for the host")


def wall_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the host clock, each run ending in
    ``torch.cuda.synchronize()``, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(n_bytes: float, n_flop: float, flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """Least time on the card (ms): bytes over the HBM rate or operations
    over the peak rate for their type (fp32 on the CUDA cores unless
    ``flop_per_s`` says otherwise), whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flop = n_flop / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")


def argmax_agreement(out: torch.Tensor, ref: torch.Tensor, tie_rtol: float) -> tuple[float, float, int]:
    """(agreement up to ties, raw argmax equality, nodes with tied tops).

    A node agrees when the class ``out`` picks is a top logit of ``ref``
    within ``tie_rtol · max |ref|``: quantized activations are often all
    zero on a node, and then every logit ties and argmax is decided by
    noise."""
    top = ref.max(-1).values
    picked = ref.gather(1, out.argmax(-1, keepdim=True))[:, 0]
    tie_tol = tie_rtol * float(ref.abs().max())
    agree = float((picked >= top - tie_tol).float().mean())
    raw = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
    tied = int(((ref >= top[:, None] - tie_tol).sum(-1) > 1).sum())
    return agree, raw, tied


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels import fake_quant as fqk
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import fm_interaction as k3
    from repro_torch.kernels import fused_gcn as fg

    t0 = time.perf_counter()
    reports = _build.build(["fused_gcn", "fm_interaction", "flash_attention", "fake_quant"])   # one nvcc per source, side by side
    lib = fg._lib()          # binds every launcher of LAUNCHES: a missing symbol raises
    lib3 = k3._lib()
    lib4 = k4._lib()
    lib5 = fqk._lib()
    seconds = time.perf_counter() - t0
    fq_ok = (lib5.fq_passes(4), lib5.fq_passes(2)) == (fqk.digit_passes(31), fqk.digit_passes(15))
    smem_ok = all(lib.k2_layer_smem_bytes(f, dt.itemsize) == fg.layer_smem_bytes(f, dt)
                  for f in (7, 16, 50, 210, fg.AF_MAX_F_IN) for dt in (torch.float32, torch.bfloat16))
    tile_ok = all((lib3.k3_tile_examples(b, f, d, dt.itemsize), bool(lib3.k3_tile_staged(b, f, d, dt.itemsize)))
                  == k3.fm_tile(b, f, d, dt) and lib3.k3_smem_bytes(b, f, d, dt.itemsize) == k3.fm_smem_bytes(b, f, d, dt)
                  for b in (1, 512, 1000, 65_536, 262_144) for f, d in ((39, 10), (8, 10), (1, 10), (40, 400), (3, 300))
                  for dt in (torch.float32, torch.bfloat16))
    xw_ok = all(lib.k2_xw_blocks(m, sms, dt.itemsize) == fg.xw_blocks(m, dt, sms)
                for m in (1, 100, 18_048, 65_792) for sms in (8, 132) for dt in (torch.float32, torch.bfloat16)) and all(
        lib.k2_xw_smem_bytes(xd.itemsize, wd.itemsize) == fg.xw_smem_bytes(xd, wd)
        for xd, wd in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)))
    k4_ok = lib4.k4_max_d() == k4.K4_MAX_D and all(
        (lib4.k4_block_rows(bf16), lib4.k4_tile_keys(bf16), lib4.k4_block_threads(bf16))
        == (k4.K4_BLOCK_ROWS[dtype], k4.K4_TILE_KEYS[dtype], k4.K4_THREADS[dtype])
        and all(lib4.k4_smem_bytes(d, bf16) == k4.k4_smem_bytes(d, dtype) for d in (16, 20, 48, 240, 256))
        for dtype, bf16 in ((torch.float32, 0), (torch.bfloat16, 1)))
    ptxas = [ln.strip() for rep in reports.values() for ln in rep.splitlines()
             if "registers" in ln or "spill" in ln]
    k4_mma = tensor_core_instructions("flash_attention", ("flash_attention_bf16_kernel", "flash_attention_f32_kernel"))
    mma_ok = (len(k4_mma["flash_attention_bf16_kernel"]) == k4.K4_MAX_D // 16
              and min(k4_mma["flash_attention_bf16_kernel"]) > 0 and k4_mma["flash_attention_f32_kernel"] == [0])
    # xw_kernel's instantiations by mangled name: <bf16, bf16, bf16> on the tensor cores, the other two none.
    xw_mma = tensor_core_instructions("fused_gcn", ("xw_kernelI13__nv_bfloat16S1_S1_", "xw_kernelI13__nv_bfloat16ff",
                                                    "xw_kernelIfff"))
    xw_mma_ok = (min(xw_mma["xw_kernelI13__nv_bfloat16S1_S1_"]) > 0 and xw_mma["xw_kernelI13__nv_bfloat16ff"] == [0]
                 and xw_mma["xw_kernelIfff"] == [0])
    emit("build", ok=smem_ok and tile_ok and xw_ok and k4_ok and mma_ok and xw_mma_ok and fq_ok, seconds=seconds,
         built=sorted(reports), ptxas=ptxas,
         k3_tile_39x10={str(b): k3.fm_tile(b, 39, 10) for b in (512, 65_536, 262_144)},
         k2_xw_blocks={"nell": fg.xw_blocks(65_792, torch.float32),
                       "rank0_bf16": fg.xw_blocks(18_048, torch.bfloat16)},
         k4_smem_bytes_d240={str(dt).replace("torch.", ""): k4.k4_smem_bytes(240, dt)
                             for dt in (torch.float32, torch.bfloat16)},
         k4_tensor_core_instructions=k4_mma,
         k2_ff_transform_tensor_core_instructions={"_bf16_all": xw_mma["xw_kernelI13__nv_bfloat16S1_S1_"],
                                                    "_bf16": xw_mma["xw_kernelI13__nv_bfloat16ff"],
                                                    "fp32": xw_mma["xw_kernelIfff"]})
    require(smem_ok, "build", "shared-memory formula or split minimum of the .cuh and the wrapper disagree")
    require(tile_ok, "build", "K3's tiling in the .cuh and in the wrapper disagree")
    require(xw_ok, "build", "the transform's grid or shared memory in the .cuh and in the wrapper disagree")
    require(xw_mma_ok, "build", f"the all-bf16 transform must run mma and the other two none: {xw_mma}")
    require(k4_ok, "build", "K4's tiles or shared memory in the .cuh and in the wrapper disagree")
    require(mma_ok, "build", f"K4's bf16 body must run mma and its fp32 body none: {k4_mma}")
    require(fq_ok, "build", "fake quant's digit passes in the .cuh and in the wrapper disagree")


def tensor_core_instructions(library: str, bodies: tuple) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in the SASS of each kernel
    whose (mangled) name holds one of ``bodies``, in the built library
    ``library``: one count per instantiation (K4's bf16 body has one per
    head width in steps of 16), read with cuobjdump."""
    import os
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                                       "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build._target(library))], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    counts = {}
    for body in bodies:
        funcs = [f for f in sass.split("Function : ")[1:] if body in f.splitlines()[0]]
        require(len(funcs) >= 1, "build", f"{body} not found in the SASS of the {library} library")
        counts[body] = [sum(1 for ln in f.splitlines() if "HMMA" in ln or "HGMMA" in ln) for f in funcs]
    return counts


def load_graph(device: torch.device) -> dict:
    from repro_torch.graph.generators import make_dataset
    from repro_torch.graph.structure import (
        GraphData, blocked_adjacency, locality_block_order, permute_edge_index,
        relocate_rows, restore_rows, to_padded,
    )

    t0 = time.perf_counter()
    spec, g = make_dataset(DATASET, seed=SEED)
    gs = g.symmetrized().with_self_loops()
    weights = gs.sym_normalized_weights()
    perm = locality_block_order(g.n_nodes, gs.edge_index)
    ei = permute_edge_index(perm, gs.edge_index)
    ba = blocked_adjacency(g.n_nodes, ei, weights)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vals, cols, lens = ba.arrays(device=device)
    pg = to_padded(GraphData(g.n_nodes, ei), weights=weights, device=device)
    x = torch.from_numpy(relocate_rows(perm, g.features)).to(device).float()
    test = relocate_rows(perm, np.arange(g.n_nodes) % 4 == 0)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    emit("data", ok=True, dataset=spec.name, n_nodes=g.n_nodes, n_edges=gs.n_edges,
         n_features=spec.n_features, n_labels=spec.n_labels, block_rows=ba.n_block_rows,
         tile_table_width=ba.max_nnzb, nnz_tiles=ba.nnz_blocks,
         mean_tiles_per_row=ba.nnz_blocks / ba.n_block_rows,
         median_tiles_per_row=float(np.median(ba.row_nnzb)), max_tiles_per_row=int(ba.row_nnzb.max()),
         padded_table_gb=ba.block_vals.nbytes / 1e9, valid_tiles_gb=ba.nnz_blocks * 128 * 128 * 4 / 1e9,
         tail_rows=g.n_nodes % 128, host_build_s=host_s, upload_s=upload_s)
    return dict(spec=spec, n=g.n_nodes, vals=vals, cols=cols, lens=lens, pg=pg, x=x,
                labels=torch.from_numpy(relocate_rows(perm, g.labels)).to(device),
                test=torch.from_numpy(test).to(device),
                ba=ba,
                host=dict(edge_index=gs.edge_index, weights=weights, features=g.features, perm=perm,
                          raw_edge_index=g.edge_index,
                          labels=g.labels, train_mask=restore_rows(perm, ~test).astype(np.float32)))


def build_plan(data: dict) -> dict:
    """The halo plan of the same graph over HALO_K ranks, and the shapes of
    its per-rank tables, before any tile of them exists."""
    from repro_torch.core.partition import partition_graph
    from repro_torch.dist.halo import get_halo_plan, plan_blocked_shape, plan_split_blocked_shape
    from repro_torch.launch.distributed_gcn import table_widths

    host = data["host"]
    t0 = time.perf_counter()
    part = partition_graph(data["n"], host["edge_index"], HALO_K, method="bfs", seed=0, refine=True)
    plan = get_halo_plan(part, host["edge_index"], host["weights"])
    host_s = time.perf_counter() - t0
    shape, split = plan_blocked_shape(plan), plan_split_blocked_shape(plan)
    tile = 128 * 128 * 4

    def padded_gb(st):
        return st["n_block_rows"] * st["max_nnzb"] * tile / 1e9

    per_rank = dict(combined=padded_gb(shape), interior=padded_gb(split["interior"]),
                    boundary=padded_gb(split["boundary"]))
    emit("plan", ok=True, k=plan.k, part_sizes=plan.part_sizes.tolist(), n_local=plan.n_local,
         s_max=plan.s_max, e_local=plan.e_local, halo_rows_per_rank=plan.halo_rows_per_device,
         broadcast_rows_per_rank=plan.broadcast_rows_per_device, wire_fraction=plan.wire_fraction(),
         overlap_fraction=plan.overlap_fraction(), neighbor_table_rows=plan.neighbor_table_rows,
         blocked_combined=shape, blocked_split=split, padded_table_gb_per_rank=per_rank,
         padded_tables_gb_all_ranks=plan.k * sum(per_rank.values()),
         valid_tiles_gb_max_rank=dict(combined=shape["nnz_blocks_max_device"] * tile / 1e9,
                                      interior=split["interior"]["nnz_blocks_max_device"] * tile / 1e9,
                                      boundary=split["boundary"]["nnz_blocks_max_device"] * tile / 1e9),
         host_build_s=host_s)
    return dict(plan=plan, part=part, widths=table_widths(plan))


def rank_operands(data: dict, halo: dict, ops: dict, generator: torch.Generator) -> dict:
    """Rank 0's combined [local ‖ halo] table and operands at its Nell
    shapes, for K2's bf16 instantiations: layer 1's feature block, layer 2's
    16-wide table (what the bf16 wire hands `k2_af_layer_bf16`)."""
    from repro_torch.dist.halo import plan_blocked_rank

    plan, device = halo["plan"], data["x"].device
    ba = plan_blocked_rank(plan, 0, max_nnzb=halo["widths"]["combined"])
    vals, cols, lens = ba.arrays(device=device)
    rows, hidden = ba.n_col_padded, ops["w1"].shape[1]
    n0 = int(plan.part_sizes[0])            # rank 0's nodes are the first n0 of the plan's order
    x0 = torch.zeros((ba.n_padded, data["spec"].n_features), device=device)
    x0[:n0] = torch.from_numpy(data["host"]["features"][plan.perm[:n0]]).to(device).float()
    return dict(vals=vals, cols=cols, lens=lens, x=x0, nnz=ba.nnz_blocks,
                table=(torch.randn((rows, hidden), generator=generator)).to(device),
                z=(torch.randn((rows, hidden), generator=generator)).to(device))


def layer_operands(data: dict, generator: torch.Generator) -> dict:
    """Random operands at the shapes of the two Nell layers, with nonzero
    biases and signed inputs so that bias and ReLU both matter."""
    spec, device = data["spec"], data["x"].device
    hidden, f_in, f_out = spec.hidden, spec.n_features, spec.n_labels
    rows = data["cols"].shape[0] * 128

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=generator) * scale).to(device)

    x = torch.zeros((rows, f_in), device=device)
    x[: data["n"]] = data["x"]
    return dict(
        x=x, w1=randn(f_in, hidden, scale=(2.0 / (f_in + hidden)) ** 0.5), b1=randn(hidden),
        h1=randn(rows, hidden), w2=randn(hidden, f_out, scale=(2.0 / (hidden + f_out)) ** 0.5),
        b2=randn(f_out),
    )


def check_kernels(data: dict, ops: dict, rank: dict, halo: dict) -> dict:
    """Each kernel against its plain version; returns the worst error per
    kernel. The halo path's shapes are rank 0's (``rank``, ``halo``)."""
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.kernels.ref import poison_padding

    vals, cols, lens = data["vals"], data["cols"], data["lens"]
    h1 = ops["h1"]
    worst = {name: 0.0 for name in fg.LAUNCHES}
    cases = []

    def hold(kernel, case, out, ref, rtol=KERNEL_RTOL):
        err, scale = max_err(out.float(), ref.float())
        ok = bool(err <= rtol * scale and out.dtype == ref.dtype)
        cases.append(dict(kernel=kernel, case=case, max_abs_err=err, max_abs_ref=scale, rtol=rtol,
                          dtype=str(out.dtype).removeprefix("torch."), ok=ok))
        worst[kernel] = max(worst[kernel], err)
        return ok

    with torch.inference_mode():
        z = fg.ff_transform(ops["x"], ops["w1"])
        hold("k2_ff_transform", "nell layer 1", z, fg.ff_transform_plain(ops["x"], ops["w1"]))
        for relu in (True, False):
            hold("k2_ff_aggregate", f"relu={relu}", fg.ff_aggregate(vals, cols, lens, z, ops["b1"], relu),
                 fg.ff_aggregate_plain(vals, cols, lens, z, ops["b1"], relu))
            hold("k2_af_layer", f"relu={relu}",
                 fg.af_layer(vals, cols, lens, ops["h1"], ops["w2"], ops["b2"], relu),
                 fg.af_layer_plain(vals, cols, lens, ops["h1"], ops["w2"], ops["b2"], relu))
        hold("k1_bsr_spmm", "nell recompute Ã·h1 (F=16)", k1.bsr_spmm(vals, cols, lens, h1),
             k1.bsr_spmm_plain(vals, cols, lens, h1))
        # Rectangular Z: twice the block-rows of the output, every other
        # tile pointing into the second half, which holds other values.
        R, T = cols.shape
        cols_rect = (cols + R * (torch.arange(T, dtype=torch.int32, device=cols.device) % 2)).contiguous()
        z_rect = torch.cat([h1, 2.0 * h1 + 1.0])
        hold("k1_bsr_spmm", "rectangular Z (2R block-rows)", k1.bsr_spmm(vals, cols_rect, lens, z_rect),
             k1.bsr_spmm_plain(vals, cols_rect, lens, z_rect))
        del cols_rect, z_rect
        # NaN in every padding tile, and block-row 1 emptied (its tiles are
        # padding now, so NaN too): finite output, equal to the clean plain
        # version, and act(b) on the empty row (zeros for K1).
        empty = 1
        lens_e = lens.clone()
        lens_e[empty] = 0
        poisoned = poison_padding(vals, lens_e)
        rows = slice(empty * 128, (empty + 1) * 128)
        for kernel, out, ref, b in (
            ("k2_ff_aggregate", fg.ff_aggregate(poisoned, cols, lens_e, z, ops["b1"], True),
             fg.ff_aggregate_plain(vals, cols, lens_e, z, ops["b1"], True), ops["b1"]),
            ("k2_af_layer", fg.af_layer(poisoned, cols, lens_e, ops["h1"], ops["w2"], ops["b2"], True),
             fg.af_layer_plain(vals, cols, lens_e, ops["h1"], ops["w2"], ops["b2"], True), ops["b2"]),
            ("k1_bsr_spmm", k1.bsr_spmm(poisoned, cols, lens_e, h1),
             k1.bsr_spmm_plain(vals, cols, lens_e, h1), torch.zeros_like(h1[0])),
        ):
            finite = bool(torch.isfinite(out).all())
            empty_ok = bool(torch.equal(out[rows], b.clamp_min(0).expand(128, -1)))
            ok = hold(kernel, "poisoned padding + empty block-row", out, ref)
            cases[-1].update(finite=finite, empty_row_is_act_b=empty_ok, ok=ok and finite and empty_ok)
        del poisoned
        check_split(data, ops, rank, hold, cases)
        check_rank_kernels(rank, halo, ops, hold)
        check_bf16_kernels(rank, ops, hold, cases)
        check_k1_bf16(rank, hold, cases)
        torch.cuda.empty_cache()
    ok = all(c["ok"] for c in cases)
    emit("kernels", ok=ok, rtol=KERNEL_RTOL, tail_rows=data["n"] % 128, cases=cases)
    require(ok, "kernels", "a kernel disagrees with its plain version")
    return worst


def skewed_table(n_src_blocks: int, device: torch.device, generator: torch.Generator) -> tuple:
    """A table the split must cut: one block-row of SKEW_LONG_ROW tiles among
    SKEW_ROWS − 1 rows of 1–3 (one of them empty), columns into
    ``n_src_blocks`` source blocks, NaN in every padding tile; returns
    (clean vals, poisoned vals, cols, lens)."""
    from repro_torch.kernels.ref import poison_padding

    lens = torch.randint(1, 4, (SKEW_ROWS,), generator=generator, dtype=torch.int32)
    lens[SKEW_ROWS // 3], lens[2 * SKEW_ROWS // 3] = SKEW_LONG_ROW, 0
    shape = (SKEW_ROWS, SKEW_LONG_ROW, 128, 128)
    vals = (torch.randn(shape, generator=generator) * 0.05).to(device)
    cols = torch.randint(0, n_src_blocks, shape[:2], generator=generator, dtype=torch.int32).to(device)
    lens = lens.to(device)
    return vals, poison_padding(vals, lens), cols, lens


def check_split(data: dict, ops: dict, rank: dict, hold, cases: list) -> None:
    """The split schedule at Nell's widths: every ragged kernel of the main
    paths over a skewed table (one block-row of 300 tiles among rows of 1–3,
    an empty row, NaN padding; source rows Nell's 16-wide h1), and the same
    call twice giving the same bits, at Nell's shapes (fp32) and rank 0's
    (bf16)."""
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fused_gcn as fg

    h1, w2, b1, b2 = ops["h1"], ops["w2"], ops["b1"], ops["b2"]
    vals, poisoned, cols, lens = skewed_table(h1.shape[0] // 128, h1.device, torch.Generator().manual_seed(SEED + 3))
    t16 = h1.to(torch.bfloat16)
    skew = f"skewed table ({SKEW_ROWS} block-rows, one of {SKEW_LONG_ROW} tiles, one empty; NaN padding)"
    for kernel, out, ref, rtol in (
        ("k1_bsr_spmm", k1.bsr_spmm(poisoned, cols, lens, h1), k1.bsr_spmm_plain(vals, cols, lens, h1), KERNEL_RTOL),
        ("k2_ff_aggregate", fg.ff_aggregate(poisoned, cols, lens, h1, b1, True),
         fg.ff_aggregate_plain(vals, cols, lens, h1, b1, True), KERNEL_RTOL),
        ("k2_af_layer", fg.af_layer(poisoned, cols, lens, h1, w2, b2, True),
         fg.af_layer_plain(vals, cols, lens, h1, w2, b2, True), KERNEL_RTOL),
        ("k2_af_layer_bf16", fg.af_layer(poisoned, cols, lens, t16, w2, b2, True),
         fg.af_layer_plain(vals, cols, lens, t16, w2, b2, True), BF16_KERNEL_RTOL),
        ("k1_bsr_spmm_bf16", k1.bsr_spmm(poisoned, cols, lens, t16), k1.bsr_spmm_plain(vals, cols, lens, t16),
         K1_BF16_STEP),
    ):
        ok = hold(kernel, skew, out, ref, rtol)
        finite = bool(torch.isfinite(out.float()).all())
        extra = dict(finite=finite)
        if kernel == "k1_bsr_spmm_bf16":
            extra.update(bit_equal=float((out == ref).float().mean()), bit_equal_min=K1_BF16_BIT_EQUAL)
            ok = ok and extra["bit_equal"] >= K1_BF16_BIT_EQUAL
        cases[-1].update(**extra, ok=ok and finite)
    del vals, poisoned, cols, lens, t16

    nv, nc, nl = data["vals"], data["cols"], data["lens"]
    rv, rc, rl = rank["vals"], rank["cols"], rank["lens"]
    z = fg.ff_transform(ops["x"], ops["w1"])
    t = rank["table"].to(torch.bfloat16)
    bf16 = torch.bfloat16
    xb, w1b = rank["x"].to(bf16), ops["w1"].to(bf16)
    for kernel, case, call in (
        ("k2_ff_transform", "nell layer 1", lambda: fg.ff_transform(ops["x"], ops["w1"])),
        ("k2_ff_transform_bf16", "rank 0 layer 1", lambda: fg.ff_transform(xb, ops["w1"])),
        ("k2_ff_transform_bf16_all", "rank 0 layer 1", lambda: fg.ff_transform(xb, w1b, bf16)),
        ("k1_bsr_spmm", "nell Ã·h1", lambda: k1.bsr_spmm(nv, nc, nl, h1)),
        ("k2_ff_aggregate", "nell layer 1", lambda: fg.ff_aggregate(nv, nc, nl, z, b1, True)),
        ("k2_af_layer", "nell layer 2", lambda: fg.af_layer(nv, nc, nl, h1, w2, b2, True)),
        ("k2_af_layer_bf16", "rank 0 table", lambda: fg.af_layer(rv, rc, rl, t, w2, b2, True)),
        ("k1_bsr_spmm_bf16", "rank 0 table", lambda: k1.bsr_spmm(rv, rc, rl, t)),
    ):
        first, second = call(), call()
        same = bool(torch.equal(first, second))
        cases.append(dict(kernel=kernel, case=f"{case}: two calls, the same bits", bit_equal_repeat=same, ok=same))
        del first, second


def split_stats(lens: torch.Tensor, T: int, name: str, ft: int, f_out: int) -> dict:
    """The split schedule of launcher ``name`` on a table: the grid, the
    row weight, the blocks that take positions and the valid tiles each
    streams (largest, mean), from `ragged_split` on this run's lens."""
    from repro_torch.kernels import fused_gcn as fg

    grid = fg.ragged_grid(name, ft, torch.cuda.current_device())
    weight = fg.ragged_row_weight(name, f_out)
    blocks = fg.ragged_split(lens.cpu().numpy(), T, grid, row_weight=weight)
    tiles = [sum(t1 - t0 for _, t0, t1 in b["segments"]) for b in blocks]
    return dict(grid=grid, row_weight=weight, blocks=len(blocks), tiles_per_block_max=max(tiles),
                tiles_per_block_mean=float(np.mean(tiles)))


def bsr_tensor(vals, cols, lens, n_src_rows: int) -> torch.Tensor:
    """The valid tiles as one ``torch.sparse_bsr_tensor`` (crow the
    cumulative sum of lens, col ``cols[r, :lens[r]]``), for the library
    yardsticks; the port never builds it."""
    R, T = cols.shape
    valid = torch.arange(T, device=cols.device)[None, :] < lens[:, None].long()
    crow = torch.zeros(R + 1, dtype=torch.int64, device=cols.device)
    crow[1:] = torch.cumsum(lens.long(), 0)
    return torch.sparse_bsr_tensor(crow, cols[valid].long(), vals[valid], size=(R * vals.shape[-2], n_src_rows))


def composition_ms(kernel: str, bsr, src, w, b, ref) -> dict:
    """The time of the composition of library calls that computes a K2
    aggregation: feature-first ``relu(addmm(b, bsr, z))``, aggregation-first
    ``relu(addmm(b, bsr @ x, w))``; checked against the plain version to
    KERNEL_RTOL of max; a yardstick the port never calls. Where CUDA refuses
    a call, the time is None and the error is kept."""
    if kernel == "k2_ff_aggregate":
        label = "torch.relu(torch.addmm(b, bsr, z)) (cuSPARSE BSR, fp32)"
        fn = lambda: torch.relu(torch.addmm(b.expand(bsr.shape[0], -1), bsr, src))
    else:
        label = "torch.relu(torch.addmm(b, bsr @ x, w)) (cuSPARSE BSR, then cuBLAS, fp32)"
        fn = lambda: torch.relu(torch.addmm(b, bsr @ src, w))
    try:
        out = fn()
    except RuntimeError as err:
        return dict(composition_ms=None, composition=label, composition_error=str(err).splitlines()[0])
    err, scale = max_err(out, ref)
    require(err <= KERNEL_RTOL * scale, "times", f"the composition for {kernel} disagrees with its plain version: "
                                                 f"{err} > {KERNEL_RTOL} · {scale}")
    del out
    return dict(composition_ms=cuda_ms(fn), composition=label, composition_max_abs_err=err)


def ragged_compiler(ft: int) -> dict:
    """Registers, local memory (spills) and blocks per SM of every ragged
    instantiation at accumulator width ``ft``, as the compiler gave them."""
    from repro_torch.kernels import fused_gcn as fg

    names = [f"{k}{sfx}" for k in ("k2_ff_aggregate", "k2_af_layer", "k1_bsr_spmm") for sfx in ("", "_bf16", "_bf16_all")]
    return {name: fg.ragged_attributes(name, ft) for name in names}


def check_rank_kernels(rank: dict, halo: dict, ops: dict, hold) -> None:
    """K1 and fp32 ``k2_af_layer`` against their plain versions at the
    shapes the halo forward gives them on rank 0: both over its
    [local ‖ halo] table (16 wide, fp32 wire), and K1 over the split pair —
    the interior table on the local block and the boundary table on the
    k·s_max-row halo block, each row-padded to the block grid as
    `repro_torch.kernels.ops.bsr_spmm` pads it."""
    from repro_torch.dist.halo import plan_blocked_rank
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fused_gcn as fg

    vals, cols, lens, table = rank["vals"], rank["cols"], rank["lens"], rank["table"]
    hold("k1_bsr_spmm", "rank 0 [local ‖ halo] table (F=16)", k1.bsr_spmm(vals, cols, lens, table),
         k1.bsr_spmm_plain(vals, cols, lens, table))
    for relu in (True, False):
        hold("k2_af_layer", f"rank 0 [local ‖ halo] table, relu={relu}",
             fg.af_layer(vals, cols, lens, table, ops["w2"], ops["b2"], relu),
             fg.af_layer_plain(vals, cols, lens, table, ops["w2"], ops["b2"], relu))
    plan, device = halo["plan"], table.device
    for part, n_rows in (("interior", plan.n_local), ("boundary", plan.k * plan.s_max)):
        ba = plan_blocked_rank(plan, 0, part=part, max_nnzb=halo["widths"][part])
        pv, pc, pl = ba.arrays(device=device)
        z = torch.zeros((ba.n_col_padded, table.shape[1]), device=device)
        z[:n_rows] = table[:n_rows]
        hold("k1_bsr_spmm", f"rank 0 {part} table over {n_rows} rows (F=16)", k1.bsr_spmm(pv, pc, pl, z),
             k1.bsr_spmm_plain(pv, pc, pl, z))
        del ba, pv, pc, pl, z


def check_bf16_kernels(rank: dict, ops: dict, hold, cases: list) -> None:
    """K2's bf16 instantiations against their plain versions at rank 0's
    shapes: layer 1's transform of its feature block, the feature-first
    aggregation and the aggregation-first layer over its [local ‖ halo]
    table (16 wide), relu on and off; the halo path's instantiation also
    with NaN-poisoned padding and an emptied block-row."""
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.kernels.ref import poison_padding

    vals, cols, lens = rank["vals"], rank["cols"], rank["lens"]
    for sfx, (vd, xd, wd) in BF16_COMBOS.items():
        rv = vals.to(vd)
        x, w1 = rank["x"].to(xd), ops["w1"].to(wd)
        out, ref = fg.ff_transform(x, w1, vd), fg.ff_transform_plain(x, w1, vd)
        if vd == torch.float32:
            hold(f"k2_ff_transform{sfx}", "rank 0 layer 1", out, ref)
        else:
            # All bf16 on the tensor cores: exact products, fp32 sums in another order, one rounding to
            # bf16, as the plain version rounds its own fp32 sums: K1 bf16's rule.
            ok = hold(f"k2_ff_transform{sfx}", "rank 0 layer 1", out, ref, K1_BF16_STEP)
            bit_equal = float((out == ref).float().mean())
            cases[-1].update(bit_equal=bit_equal, bit_equal_min=K1_BF16_BIT_EQUAL,
                             ok=ok and bit_equal >= K1_BF16_BIT_EQUAL)
        del out, ref
        z, t, w2 = rank["z"].to(vd), rank["table"].to(xd), ops["w2"].to(wd)
        for relu in (True, False):
            hold(f"k2_ff_aggregate{sfx}", f"rank 0 table, relu={relu}",
                 fg.ff_aggregate(rv, cols, lens, z, ops["b1"], relu, xd),
                 fg.ff_aggregate_plain(rv, cols, lens, z, ops["b1"], relu, xd), BF16_KERNEL_RTOL)
            hold(f"k2_af_layer{sfx}", f"rank 0 table, relu={relu}",
                 fg.af_layer(rv, cols, lens, t, w2, ops["b2"], relu),
                 fg.af_layer_plain(rv, cols, lens, t, w2, ops["b2"], relu), BF16_KERNEL_RTOL)
        del rv, x, w1, z, t, w2
    empty = 1
    lens_e = lens.clone()
    lens_e[empty] = 0
    t = rank["table"].to(torch.bfloat16)
    out = fg.af_layer(poison_padding(vals, lens_e), cols, lens_e, t, ops["w2"], ops["b2"], True)
    ref = fg.af_layer_plain(vals, cols, lens_e, t, ops["w2"], ops["b2"], True)
    finite = bool(torch.isfinite(out.float()).all())
    empty_ok = bool(torch.equal(out[empty * 128:(empty + 1) * 128],
                                ops["b2"].clamp_min(0).to(torch.bfloat16).expand(128, -1)))
    ok = hold("k2_af_layer_bf16", "rank 0 table, poisoned padding + empty block-row", out, ref, BF16_KERNEL_RTOL)
    cases[-1].update(finite=finite, empty_row_is_act_b=empty_ok, ok=ok and finite and empty_ok)


def check_k1_bf16(rank: dict, hold, cases: list) -> None:
    """K1's bf16 instantiations against their plain version (the
    reference's per-tile rounding of the running sum) at rank 0's shape:
    its [local ‖ halo] table and a 16-wide bf16 table (what the bf16 wire
    hands the aggregation-first recompute), clean and with NaN-poisoned
    padding and an emptied block-row. Within one bf16 step of the largest
    value, and at least K1_BF16_BIT_EQUAL of the elements bit-equal."""
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels.ref import poison_padding

    vals, cols, lens = rank["vals"], rank["cols"], rank["lens"]
    t = rank["table"].to(torch.bfloat16)
    empty = 1
    lens_e = lens.clone()
    lens_e[empty] = 0
    for sfx, (vd, zd) in K1_BF16_COMBOS.items():
        rv = vals.to(vd)
        for case, kv, kl in (("rank 0 table (F=16)", rv, lens),
                             ("rank 0 table, poisoned padding + empty block-row", poison_padding(rv, lens_e), lens_e)):
            out = k1.bsr_spmm(kv, cols, kl, t)
            ref = k1.bsr_spmm_plain(rv, cols, kl, t)
            ok = hold(f"k1_bsr_spmm{sfx}", case, out, ref, K1_BF16_STEP)
            bit_equal = float((out == ref).float().mean())
            finite = bool(torch.isfinite(out.float()).all())
            empty_ok = kl is lens or bool((out[empty * 128:(empty + 1) * 128] == 0).all())
            cases[-1].update(bit_equal=bit_equal, bit_equal_min=K1_BF16_BIT_EQUAL, finite=finite,
                             empty_row_is_zero=empty_ok, ok=ok and bit_equal >= K1_BF16_BIT_EQUAL and finite and empty_ok)
            del kv, out, ref
        del rv


def run_fake_quant(data: dict, ops: dict) -> None:
    """The `fake_quant` line: the fake-quant kernels
    (`repro_torch.kernels.fake_quant`) against their plain version, the
    PyTorch ops, at Nell's X and at H = relu(X·W1 + b1) with percentile
    99.9, at W1 and W2 with the max, and at X and H in bf16 (the halo's
    bf16 wire): the same bits (max |difference| 0), the device ms of a call
    (`device_ms`) beside the plain version's and the bound (x read once
    and the output written once: 2 · bytes at the HBM rate), and the
    launches a call."""
    from repro_torch.kernels import fake_quant as fqk

    t0 = time.perf_counter()
    h = torch.relu(data["x"] @ ops["w1"] + ops["b1"])
    cases = {"x": (data["x"], 99.9), "h": (h, 99.9), "w1": (ops["w1"], None), "w2": (ops["w2"], None),
             "x_bf16": (data["x"].to(torch.bfloat16), 99.9), "h_bf16": (h.to(torch.bfloat16), 99.9)}
    rows, ok = {}, True
    for name, (t, percentile) in cases.items():
        before = dict(fqk.LAUNCHES)
        out = fqk.fake_quant(t, 4, percentile)
        launches = {k: n - before[k] for k, n in fqk.LAUNCHES.items() if n != before[k]}
        ref = fqk.fake_quant_plain(t, 4, percentile)
        nan = torch.isnan(ref)
        same = bool(torch.equal(torch.isnan(out), nan)) and bool(torch.equal(out[~nan], ref[~nan]))
        diff = float((out.float() - ref.float()).abs().nan_to_num(float("inf")).max())
        ok &= same
        rows[name] = dict(shape=list(t.shape), dtype=str(t.dtype).replace("torch.", ""), percentile=percentile,
                          same_bits=same, max_abs_diff=diff,
                          ms=device_ms(lambda: fqk.fake_quant(t, 4, percentile)),
                          plain_ms=device_ms(lambda: fqk.fake_quant_plain(t, 4, percentile), reps=5),
                          bound_ms=bound(2 * t.numel() * t.element_size(), 0)[0], launches_a_call=launches)
        del out, ref, nan
    del cases, h
    torch.cuda.empty_cache()
    emit("fake_quant", ok=ok, rows=rows, seconds=time.perf_counter() - t0,
         note="kernel and plain: device ms of one call (device_ms); bound: 2 × bytes at 3.35 TB/s")
    require(ok, "fake_quant", f"the kernels' bits differ from the ops': {rows}")


def run_main_path(data: dict) -> dict:
    from repro_torch.configs.coin_gcn import make_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.gcn import gcn_forward, gcn_init

    device = data["x"].device
    pg = data["pg"]
    cfg = dataclasses.replace(make_config(dataset=DATASET), backend="bsr")
    params = gcn_init(torch.Generator().manual_seed(SEED), cfg, device=device)
    adjacency = (data["vals"], data["cols"], data["lens"])

    def forward(c):
        return gcn_forward(params, data["x"], pg.senders, pg.receivers, pg.edge_weight, c,
                           adjacency=adjacency if c.backend == "bsr" else None)

    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launch_counts()
        for _ in range(PASSES):
            logits = forward(cfg)
        torch.cuda.synchronize()
        launches = launch_counts()
        quant_off = dataclasses.replace(cfg, quant=QuantConfig(enabled=False))
        logits_off = forward(quant_off)
        err, scale = max_err(logits_off, forward(dataclasses.replace(quant_off, backend="segment")))
        ref_q = forward(dataclasses.replace(cfg, backend="segment"))
    expected = {name: PASSES if name in K2 else 0 for name in launches}   # K1 runs in training only
    expected.update({name: PASSES * n for name, n in FQ_LAUNCHES_PER_FORWARD.items()})
    # Agreement up to ties: a node agrees when the class the kernel path
    # picks is a top logit of the plain path within the logit tolerance.
    agree, raw_agree, tied = argmax_agreement(logits, ref_q, LOGIT_RTOL)
    pred = logits.argmax(-1) == data["labels"]
    acc = float(pred[data["test"]].float().mean())
    checks = dict(
        launches=launches == expected,
        shape=tuple(logits.shape) == (data["n"], data["spec"].n_labels),
        finite=bool(torch.isfinite(logits).all()),
        quant_off_logits=bool(err <= LOGIT_RTOL * scale),
        quant_on_argmax=agree >= ARGMAX_AGREEMENT,
    )
    emit("main", ok=all(checks.values()), checks=checks, passes=PASSES, launches=launches,
         expected_launches=expected, quant_off_max_abs_err=err, quant_off_max_abs_logit=scale,
         logit_rtol=LOGIT_RTOL, quant_on_max_abs_diff=max_err(logits, ref_q)[0],
         quant_on_argmax_agreement=agree, argmax_agreement_min=ARGMAX_AGREEMENT,
         quant_on_raw_argmax_equal=raw_agree, quant_on_nodes_with_tied_top_logits=tied,
         test_accuracy=acc, note="random weights: accuracy is near chance")
    require(all(checks.values()), "main", f"checks {checks}")
    return dict(launches=launches, forward=forward, cfg=cfg, logits_quant_off=logits_off.cpu().numpy())


def run_training(data: dict) -> dict:
    """The training path: one quant-off gradient on each backend, five
    quant-on AdamW steps of a `Trainer` with the launch counts (K1, K2 and
    fake quant) zeroed just before and read just after, five quant-off
    steps on each backend."""
    from repro_torch.configs.coin_gcn import make_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.gcn import gcn_forward, gcn_init, gcn_loss
    from repro_torch.train.loop import Trainer, TrainerConfig, value_and_grad
    from repro_torch.train.optimizer import adamw

    device = data["x"].device
    pg = data["pg"]
    cfg = dataclasses.replace(make_config(dataset=DATASET), backend="bsr")
    quant_off = dataclasses.replace(cfg, quant=QuantConfig(enabled=False))
    adjacency = (data["vals"], data["cols"], data["lens"])
    batch = dict(x=data["x"], labels=data["labels"], mask=(~data["test"]).float())

    def loss_fn(c):
        kw = {"adjacency": adjacency} if c.backend == "bsr" else {}

        def loss(p, b):
            return gcn_loss(p, b["x"], pg.senders, pg.receivers, pg.edge_weight, b["labels"], b["mask"],
                            c, **kw)
        return loss

    def trainer(c):
        params = gcn_init(torch.Generator().manual_seed(SEED), c, device=device)
        return Trainer(loss_fn(c), adamw(), params, TrainerConfig(log_every=TRAIN_STEPS + 1))

    def fit(tr):
        return tr.fit(iter(lambda: batch, None), max_steps=TRAIN_STEPS)

    # One quant-off gradient through the kernels and the reference's VJP,
    # against autograd through the segment path.
    grads = {}
    for backend in ("bsr", "segment"):
        c = dataclasses.replace(quant_off, backend=backend)
        params = gcn_init(torch.Generator().manual_seed(SEED), c, device=device)
        _, grads[backend] = value_and_grad(loss_fn(c), params, batch)
    grad_err = {k: max_err(grads["bsr"][k], grads["segment"][k]) for k in grads["bsr"]}
    grads_bsr = {k: g.cpu().numpy() for k, g in grads["bsr"].items()}    # the sharded gradients' reference
    del grads

    # The same gradient with the logits rounded to bf16 before the loss (and
    # so their cotangent), as the sharded bf16 path's fused layer emits them:
    # the reference of that path's gradient.
    def bf16_logits_loss(p, b):
        logits = gcn_forward(p, b["x"], pg.senders, pg.receivers, pg.edge_weight, quant_off,
                             adjacency=adjacency).to(torch.bfloat16).float()
        gold = torch.gather(logits, 1, b["labels"].long()[:, None])[:, 0]
        return ((torch.logsumexp(logits, dim=-1) - gold) * b["mask"]).sum() / b["mask"].sum()

    params = gcn_init(torch.Generator().manual_seed(SEED), quant_off, device=device)
    grads_bsr_bf16 = {k: g.cpu().numpy() for k, g in value_and_grad(bf16_logits_loss, params, batch)[1].items()}

    tr = trainer(cfg)
    torch.cuda.synchronize()
    reset_launch_counts()
    losses = fit(tr)
    torch.cuda.synchronize()
    launches = launch_counts()
    del tr

    trajectory = {b: fit(trainer(dataclasses.replace(quant_off, backend=b))) for b in ("bsr", "segment")}
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(trajectory["bsr"], trajectory["segment"])]
    expected = {name: TRAIN_STEPS if name in FP32_KERNELS else 0 for name in launches}
    expected.update({name: TRAIN_STEPS * n for name, n in FQ_LAUNCHES_PER_FORWARD.items()})
    checks = dict(
        launches=launches == expected,
        gradients=all(err <= GRAD_RTOL * scale for err, scale in grad_err.values()),
        finite_losses=len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
        quant_off_trajectory=len(loss_rel) == TRAIN_STEPS and max(loss_rel) <= LOSS_RTOL,
    )
    emit("train", ok=all(checks.values()), checks=checks, steps=TRAIN_STEPS, optimizer="adamw(lr=1e-3)",
         launches=launches, expected_launches=expected, losses_bsr_quant_on=losses,
         grad_max_abs_err={k: e for k, (e, _) in grad_err.items()},
         grad_max_abs={k: s for k, (_, s) in grad_err.items()}, grad_rtol=GRAD_RTOL,
         losses_quant_off=trajectory, loss_max_rel_diff=max(loss_rel), loss_rtol=LOSS_RTOL)
    require(all(checks.values()), "train", f"checks {checks}")
    return dict(launches=launches, trainer=trainer, batch=batch, cfg=cfg, quant_off=quant_off,
                grads_bsr_quant_off=grads_bsr, grads_bsr_quant_off_bf16_logits=grads_bsr_bf16,
                losses_bsr_quant_off=trajectory["bsr"])


def time_everything(data: dict, ops: dict, main: dict, train: dict) -> tuple[dict, dict]:
    from repro_torch.core.quant import fake_quant
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.kernels.ops import _bsr_t_apply

    vals, cols, lens = data["vals"], data["cols"], data["lens"]
    nnz = int(lens.sum())
    R, B = cols.shape[0], 128
    x, w1, b1, h1, w2, b2 = (ops[k] for k in ("x", "w1", "b1", "h1", "w2", "b2"))
    M, K = x.shape
    hidden, f_out = w1.shape[1], w2.shape[1]
    tiles, idx = 4.0 * nnz * B * B, 4.0 * (R + nnz)
    with torch.inference_mode():
        z = fg.ff_transform(x, w1)
        rows = {
            "k2_ff_transform": dict(
                ms=device_ms(lambda: fg.ff_transform(x, w1)),
                call_ms=cuda_ms(lambda: fg.ff_transform(x, w1)),
                plain_ms=device_ms(lambda: fg.ff_transform_plain(x, w1)),
                library_ms=device_ms(lambda: torch.mm(x, w1)),
                bound=bound(4.0 * (M * K + K * hidden + M * hidden), 2.0 * M * K * hidden)),
            "k2_ff_aggregate": dict(
                ms=cuda_ms(lambda: fg.ff_aggregate(vals, cols, lens, z, b1, True)),
                plain_ms=cuda_ms(lambda: fg.ff_aggregate_plain(vals, cols, lens, z, b1, True)),
                library_ms=None,
                bound=bound(tiles + idx + 4.0 * (z.numel() + hidden + R * B * hidden),
                            2.0 * nnz * B * B * hidden + R * B * hidden)),
            "k2_af_layer": dict(
                ms=cuda_ms(lambda: fg.af_layer(vals, cols, lens, h1, w2, b2, True)),
                plain_ms=cuda_ms(lambda: fg.af_layer_plain(vals, cols, lens, h1, w2, b2, True)),
                library_ms=None,
                bound=bound(tiles + idx + 4.0 * (h1.numel() + w2.numel() + f_out + R * B * f_out),
                            2.0 * nnz * B * B * hidden + 2.0 * R * B * hidden * f_out)),
            "k1_bsr_spmm": dict(
                ms=cuda_ms(lambda: k1.bsr_spmm(vals, cols, lens, h1)),
                plain_ms=cuda_ms(lambda: k1.bsr_spmm_plain(vals, cols, lens, h1)),
                bound=bound(tiles + idx + 4.0 * (h1.numel() + R * B * hidden), 2.0 * nnz * B * B * hidden)),
        }
        rows["k1_bsr_spmm"].update(bsr_library_ms(vals, cols, lens, h1))
        bsr = bsr_tensor(vals, cols, lens, h1.shape[0])
        rows["k2_ff_aggregate"].update(composition_ms("k2_ff_aggregate", bsr, z, None, b1,
                                                      fg.ff_aggregate_plain(vals, cols, lens, z, b1, True)))
        rows["k2_af_layer"].update(composition_ms("k2_af_layer", bsr, h1, w2, b2,
                                                  fg.af_layer_plain(vals, cols, lens, h1, w2, b2, True)))
        del bsr
        T = cols.shape[1]
        for name, f in (("k2_ff_aggregate", hidden), ("k2_af_layer", f_out), ("k1_bsr_spmm", hidden)):
            rows[name]["split"] = split_stats(lens, T, name, hidden, f)
        # The backward's torch parts at Nell's shapes: both layers' blocked
        # transposes take a 16-wide cotangent (layer 1's dpre, layer 2's
        # dm = g·W2ᵀ), and layer 1's dw = Xᵀ·dz is the one large matmul.
        # Each apply finds the valid tiles itself (since PR 27, as in the
        # backward), so its time includes that `nonzero`.
        g1, g2 = torch.randn_like(h1), torch.randn_like(h1)
        backward = dict(
            bsr_t_apply_layer1_ms=cuda_ms(lambda: _bsr_t_apply(vals, cols, lens, g1, M)),
            bsr_t_apply_layer2_ms=cuda_ms(lambda: _bsr_t_apply(vals, cols, lens, g2, M)),
            dw_xt_dz_ms=cuda_ms(lambda: x.T @ g1),
        )
        del g1, g2
        forward, cfg = main["forward"], main["cfg"]
        seg = dataclasses.replace(cfg, backend="segment")
        torch.cuda.reset_peak_memory_stats()
        totals = dict(
            forward_bsr_quant_ms=cuda_ms(lambda: forward(cfg), reps=5),
            forward_bsr_noquant_ms=cuda_ms(
                lambda: forward(dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, enabled=False))),
                reps=5),
            forward_segment_quant_ms=cuda_ms(lambda: forward(seg), reps=5),
            fake_quant_x_ms=cuda_ms(lambda: fake_quant(data["x"], 4, percentile=99.9), reps=5),
            peak_memory_forward_gb=torch.cuda.max_memory_allocated() / 1e9,
        )

    def step_ms(c):
        tr = train["trainer"](c)

        def one():
            tr.params, tr.opt_state, tr.residual, loss = tr._step_fn(
                tr.params, tr.opt_state, tr.residual, train["batch"])
            float(loss)
        return wall_ms(one)

    cfg, quant_off = train["cfg"], train["quant_off"]
    torch.cuda.reset_peak_memory_stats()
    totals["train_step_bsr_quant_ms"] = step_ms(cfg)
    totals["peak_memory_train_step_gb"] = torch.cuda.max_memory_allocated() / 1e9
    totals["train_step_bsr_noquant_ms"] = step_ms(quant_off)
    totals["train_step_segment_quant_ms"] = step_ms(dataclasses.replace(cfg, backend="segment"))
    emit("times", ok=True, reps=dict(kernel=10, forward=5, train_step=5), **totals, backward=backward,
         resident_tile_table_gb=vals.numel() * 4 / 1e9,
         kernels={k: {**v, "bound": list(v["bound"])} for k, v in rows.items()},
         split_note="split: the ragged kernels' grid (one wave: SMs × blocks per SM), the row weight, the blocks "
                    "that take positions and the valid tiles each streams (largest, mean) on this table, from "
                    "ragged_split (the numpy mirror of the kernel's schedule) on this run's lens")
    compiler = ragged_compiler(hidden)
    emit("ragged_compiler", ok=True, ft=hidden, compiler=compiler,
         spills=sum(c["local_bytes"] for c in compiler.values()),
         note="cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor of each "
              "ragged_layer_kernel instantiation at Nell's 16-wide accumulator")
    return rows, totals


def bsr_library_ms(vals, cols, lens, z) -> dict:
    """K1's library yardstick: one ``torch.sparse_bsr_tensor(...) @ z`` call
    (cuSPARSE's BSR product in fp32) on the same table, built outside the
    timed call: crow the cumulative sum of ``lens``, col ``cols[r, :lens[r]]``
    and the valid tiles as values. Checked against K1's plain version to
    KERNEL_RTOL of max; the port never calls it. Where CUDA refuses the
    call, ``library_ms`` is None and ``library_error`` says why."""
    from repro_torch.kernels import bsr_spmm as k1

    bsr = bsr_tensor(vals, cols, lens, z.shape[0])
    try:
        out = bsr @ z
    except RuntimeError as err:
        return dict(library_ms=None, library_error=str(err).splitlines()[0])
    err, scale = max_err(out, k1.bsr_spmm_plain(vals, cols, lens, z))
    require(err <= KERNEL_RTOL * scale, "times", f"the BSR library product disagrees with K1's plain version: "
                                                 f"{err} > {KERNEL_RTOL} · {scale}")
    del out
    return dict(library_ms=cuda_ms(lambda: bsr @ z), library_max_abs_err=err,
                library="torch.sparse_bsr_tensor(crow, col, values) @ h1 (cuSPARSE BSR, fp32)")


def time_bf16_kernels(rank: dict, ops: dict) -> dict:
    """CUDA-event medians of K2's and K1's bf16 instantiations at rank 0's shapes,
    their plain versions and, where one PyTorch call computes the same
    function, that call; with ``k2_af_layer`` (fp32) at the same shape
    beside the halo path's ``k2_af_layer_bf16``. Bounds count each element
    at its own width (2 bytes for bf16)."""
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fused_gcn as fg

    vals, cols, lens, nnz = rank["vals"], rank["cols"], rank["lens"], rank["nnz"]
    R, B = cols.shape[0], 128
    size = {torch.float32: 4.0, torch.bfloat16: 2.0}
    idx = 4.0 * (R + nnz)
    rows = {}
    with torch.inference_mode():
        for sfx, (vd, xd, wd) in BF16_COMBOS.items():
            rate = BF16_FLOP_PER_S if (vd, xd, wd) == (torch.bfloat16,) * 3 else FP32_FLOP_PER_S
            rv, x, w1, w2 = vals.to(vd), rank["x"].to(xd), ops["w1"].to(wd), ops["w2"].to(wd)
            z, t, b1, b2 = rank["z"].to(vd), rank["table"].to(xd), ops["b1"], ops["b2"]
            M, K = x.shape
            hidden, f_out = w1.shape[1], w2.shape[1]
            tiles = size[vd] * nnz * B * B
            rows[f"k2_ff_transform{sfx}"] = dict(
                ms=device_ms(lambda: fg.ff_transform(x, w1, vd)),
                call_ms=cuda_ms(lambda: fg.ff_transform(x, w1, vd)),
                plain_ms=device_ms(lambda: fg.ff_transform_plain(x, w1, vd)),
                library_ms=device_ms(lambda: torch.mm(x, w1)) if xd == wd else None,
                bound=bound(size[xd] * M * K + size[wd] * K * hidden + size[vd] * M * hidden,
                            2.0 * M * K * hidden, rate))
            rows[f"k2_ff_aggregate{sfx}"] = dict(
                ms=cuda_ms(lambda: fg.ff_aggregate(rv, cols, lens, z, b1, True, xd)),
                plain_ms=cuda_ms(lambda: fg.ff_aggregate_plain(rv, cols, lens, z, b1, True, xd)),
                library_ms=None,
                bound=bound(tiles + idx + size[vd] * z.numel() + 4.0 * hidden + size[xd] * R * B * hidden,
                            2.0 * nnz * B * B * hidden + R * B * hidden, rate))
            rows[f"k2_af_layer{sfx}"] = dict(
                ms=cuda_ms(lambda: fg.af_layer(rv, cols, lens, t, w2, b2, True)),
                plain_ms=cuda_ms(lambda: fg.af_layer_plain(rv, cols, lens, t, w2, b2, True)),
                library_ms=None,
                bound=bound(tiles + idx + size[xd] * t.numel() + size[wd] * w2.numel() + 4.0 * f_out
                            + size[xd] * R * B * f_out,
                            2.0 * nnz * B * B * hidden + 2.0 * R * B * hidden * f_out, rate))
            del rv, x, w1, w2, z, t
        for sfx, (vd, zd) in K1_BF16_COMBOS.items():
            rv, t = vals.to(vd), rank["table"].to(zd)
            F = t.shape[1]
            rate = BF16_FLOP_PER_S if vd == torch.bfloat16 else FP32_FLOP_PER_S
            rows[f"k1_bsr_spmm{sfx}"] = dict(
                ms=cuda_ms(lambda: k1.bsr_spmm(rv, cols, lens, t)),
                plain_ms=cuda_ms(lambda: k1.bsr_spmm_plain(rv, cols, lens, t)),
                library_ms=None,
                bound=bound(size[vd] * nnz * B * B + idx + size[zd] * (t.numel() + R * B * F),
                            2.0 * nnz * B * B * F, rate))
            del rv, t
        for name, row in rows.items():
            if not name.startswith("k2_ff_transform"):
                row["split"] = split_stats(lens, cols.shape[1], name, rank["table"].shape[1],
                                           ops["w2"].shape[1] if "af_layer" in name else rank["table"].shape[1])
        t32 = rank["table"]
        af32_ms = cuda_ms(lambda: fg.af_layer(vals, cols, lens, t32, ops["w2"], ops["b2"], True))
        af32_bound = bound(4.0 * nnz * B * B + idx + 4.0 * (t32.numel() + ops["w2"].numel() + ops["w2"].shape[1]
                                                             + R * B * ops["w2"].shape[1]),
                           2.0 * nnz * B * B * t32.shape[1] + 2.0 * R * B * ops["w2"].numel())
    emit("times_rank", ok=True, rank=0, block_rows=R, tile_table_width=int(cols.shape[1]), nnz_tiles=nnz,
         table_rows=int(rank["table"].shape[0]), reps=10,
         af_layer_bf16_vs_fp32=dict(bf16_ms=rows["k2_af_layer_bf16"]["ms"],
                                    bf16_bound=list(rows["k2_af_layer_bf16"]["bound"]),
                                    fp32_ms=af32_ms, fp32_bound=list(af32_bound)),
         kernels={k: {**v, "bound": list(v["bound"])} for k, v in rows.items()},
         timing="k2_ff_transform*: ms, plain_ms and library_ms are device_ms (20 calls queued behind a spin "
                "kernel, back to back between two CUDA events); call_ms the CUDA-event median of one call, the "
                "host's launch included; the other rows CUDA events")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grids = {"k2_ff_transform": fg.xw_blocks(65_792, torch.float32, sms),
             "k2_ff_transform_bf16": fg.xw_blocks(rank["x"].shape[0], torch.bfloat16, sms),
             "k2_ff_transform_bf16_all": fg.xw_blocks(rank["x"].shape[0], torch.bfloat16, sms)}
    compiler = {name: dict(grid=g, **fg.transform_attributes(name)) for name, g in grids.items()}
    emit("dense_compiler", ok=True, compiler=compiler,
         spills=sum(c["local_bytes"] for c in compiler.values()),
         note="cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor of each xw_kernel "
              "instantiation (8 warps a block) and its grid at Nell (fp32) and rank 0 (bf16); K3's on the "
              "deepfm_kernels line")
    return rows


def profile_train_steps(train: dict, steps: int = 3) -> None:
    """Device time by kernel name and the idle share of the card over
    ``steps`` bsr quant-on training steps, from torch.profiler's CUDA events
    (their union is the busy time; the window spans every recorded event)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.trace import device_time_summary

    tr = train["trainer"](train["cfg"])

    def one():
        tr.params, tr.opt_state, tr.residual, loss = tr._step_fn(
            tr.params, tr.opt_state, tr.residual, train["batch"])
        float(loss)

    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
    emit("profile", ok=True, steps=steps, **device_time_summary(list(prof.events()), steps),
         note="profiler overhead lengthens the host side of the window")


def halo_variants():
    from repro_torch.launch.distributed_gcn import HaloVariant as V

    return (V("a_fp32"), V("b_bf16", payload="bf16"), V("c_split_fp32", split=True), V("d_int8", payload="int8"),
            V("e_bsr_quant_bf16", payload="bf16", quant=True),
            V("e_segment_quant_bf16", backend="segment", payload="bf16", quant=True))


# Launches per rank in one forward: layer 1 (5,414 → 16, feature-first) is
# X·W (torch.matmul) then K1 over the [local ‖ halo] table, or K1 on the
# interior and the boundary table; layer 2 (16 → 210, aggregation-first)
# is one K2 launch over the combined table (bf16 table under the bf16
# wire), or K1 twice and X·W on the split pair. The segment path runs none.
# Quant on, either backend runs fake quant's (FQ_LAUNCHES_PER_FORWARD: each
# rank calibrates on its own fp32 block).
HALO_LAUNCHES = {
    "a_fp32": {"k1_bsr_spmm": 1, "k2_af_layer": 1},
    "b_bf16": {"k1_bsr_spmm": 1, "k2_af_layer_bf16": 1},
    "c_split_fp32": {"k1_bsr_spmm": 4},
    "d_int8": {"k1_bsr_spmm": 1, "k2_af_layer": 1},
    "e_bsr_quant_bf16": {"k1_bsr_spmm": 1, "k2_af_layer_bf16": 1, **FQ_LAUNCHES_PER_FORWARD},
    "e_segment_quant_bf16": dict(FQ_LAUNCHES_PER_FORWARD),
}


def halo_train_variants():
    from repro_torch.launch.distributed_gcn import HaloVariant as V

    return (V("t1_fp32"), V("t2_bf16", payload="bf16"), V("t3_split_fp32", split=True),
            V("t4_bsr_quant_bf16", payload="bf16", quant=True),
            V("t4_segment_quant_bf16", backend="segment", payload="bf16", quant=True, round_logits=True))


# Launches per rank in one training step: the forward's (HALO_LAUNCHES) and,
# for the combined table's aggregation-first layer 2, K1 once more in its
# backward (the recompute M = Ã·table; under the bf16 wire its bf16
# instantiation). The backward's blocked transposes are torch ops.
HALO_TRAIN_LAUNCHES = {
    "t1_fp32": {"k1_bsr_spmm": 2, "k2_af_layer": 1},
    "t2_bf16": {"k1_bsr_spmm": 1, "k2_af_layer_bf16": 1, "k1_bsr_spmm_bf16": 1},
    "t3_split_fp32": {"k1_bsr_spmm": 4},
    "t4_bsr_quant_bf16": {"k1_bsr_spmm": 1, "k2_af_layer_bf16": 1, "k1_bsr_spmm_bf16": 1,
                          **FQ_LAUNCHES_PER_FORWARD},
    "t4_segment_quant_bf16": dict(FQ_LAUNCHES_PER_FORWARD),
}


def run_halo(host: dict, halo: dict, main: dict, train: dict) -> dict:
    """The sharded forward and sharded training on HALO_K ranks sharing the
    card, in one group: the forward against the unsharded bsr forward, the
    training (`halo_train` line) against the unsharded bsr train phase, and
    at the end `overlap_timeline` (rank 0 traces); returns each kernel's
    launches summed over the ranks' forwards (one per variant) and over their
    training steps, each variant's restored logits, the unsharded reference
    and rank 0's trace recorder."""
    from repro_torch.configs.coin_gcn import make_config
    from repro_torch.dist.halo import restore_node_array
    from repro_torch.graph.structure import restore_rows
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.distributed_gcn import halo_rank, rank_jobs
    from repro_torch.launch.mesh import GroupSpec, run_group
    from repro_torch.models.gcn import gcn_init

    plan = halo["plan"]
    cfg = make_config(dataset=DATASET)
    params = {k: v.numpy() for k, v in gcn_init(torch.Generator().manual_seed(SEED), cfg, device="cpu").items()}
    variants = halo_variants()
    t0 = time.perf_counter()
    jobs = rank_jobs(plan, host["features"], params, cfg.layer_dims, variants, quant=cfg.quant,
                     time_reps=HALO_REPS, labels=host["labels"], mask=host["train_mask"],
                     train_variants=halo_train_variants(), steps=HALO_TRAIN_STEPS, lr=HALO_TRAIN_LR,
                     obs_trace=True)
    spec = GroupSpec(k=HALO_K, backend="gloo", devices=("cuda:0",), timeout_s=HALO_TIMEOUT_S)
    print(f"halo group: {spec.describe()}", flush=True)
    results = run_group(spec, halo_rank, jobs)
    seconds = time.perf_counter() - t0
    ref = restore_rows(host["perm"], main["logits_quant_off"])        # unsharded bsr, global node order
    ref_scale = float(np.abs(ref).max())
    per_variant, checks = {}, {}
    launches = dict.fromkeys(launch_counts(), 0)
    logits = {}
    for v in variants:
        recs = [r["variants"][v.name] for r in results]
        logits[v.name] = restore_node_array(plan, np.stack([rec["logits"] for rec in recs]))
        for rec in recs:
            for name, n in rec["launches"].items():
                launches[name] += n
        per_variant[v.name] = dict(
            backend=v.backend, payload=v.payload or "fp32", tables="split" if v.split else "combined",
            quant=v.quant, dtype=recs[0]["dtype"], launches_per_rank=[rec["launches"] for rec in recs],
            wire_rows_per_rank=[rec["wire_rows"] for rec in recs],
            wire_bytes_per_rank=[rec["wire_bytes"] for rec in recs],
            forward_ms_per_rank=[rec.get("forward_ms") for rec in recs])
        checks[f"{v.name}_launches"] = all(rec["launches"] == HALO_LAUNCHES[v.name] for rec in recs)
        checks[f"{v.name}_wire_rows"] = all(rec["wire_rows"] == (cfg.n_layers * plan.halo_rows_per_device)
                                            for rec in recs)
        checks[f"{v.name}_finite"] = all(rec["finite"] for rec in recs) and bool(np.isfinite(logits[v.name]).all())
        checks[f"{v.name}_shape"] = logits[v.name].shape == ref.shape
    for name, rtol in (("a_fp32", HALO_LOGIT_RTOL), ("c_split_fp32", HALO_LOGIT_RTOL), ("b_bf16", HALO_BF16_RTOL)):
        err = float(np.abs(logits[name] - ref).max())
        per_variant[name].update(max_abs_err_vs_unsharded=err, rtol=rtol)
        checks[f"{name}_vs_unsharded"] = err <= rtol * ref_scale
    diff = logits["d_int8"] - ref
    err8, rel8 = float(np.abs(diff).max()), float(np.linalg.norm(diff) / np.linalg.norm(ref))
    per_variant["d_int8"].update(max_abs_err_vs_unsharded=err8, rel_l2_vs_unsharded=rel8,
                                 max_abs_bound=HALO_INT8_ABS, rel_l2_bound=HALO_INT8_REL_L2)
    checks["d_int8_vs_unsharded"] = err8 < HALO_INT8_ABS and rel8 <= HALO_INT8_REL_L2
    # (e): the main phase's rule, ties within LOGIT_RTOL · max |logit|. The
    # bsr path's logits are bf16 (the fused bf16 layer's output), so the
    # agreement with ties within the bf16 tolerance is reported beside it.
    eb, es = torch.from_numpy(logits["e_bsr_quant_bf16"]), torch.from_numpy(logits["e_segment_quant_bf16"])
    agree, raw, tied = argmax_agreement(eb, es, LOGIT_RTOL)
    agree_bf16_ties = argmax_agreement(eb, es, HALO_BF16_RTOL)[0]
    checks["e_argmax_agreement"] = agree >= ARGMAX_AGREEMENT
    ok = all(checks.values())
    emit("halo", ok=ok, checks=checks, reduced=HALO_REPS_REDUCED, ranks=HALO_K, group=spec.describe(),
         shared_card="cuda:0",
         wire="gloo through the host (NCCL not exercised: one card)", seconds=seconds,
         halo_rows_per_rank_per_exchange=plan.halo_rows_per_device, k_s_max=plan.k * plan.s_max,
         exchanges_per_forward=cfg.n_layers, max_abs_logit_unsharded=ref_scale, variants=per_variant,
         e_argmax_agreement=agree, e_argmax_agreement_bf16_ties=agree_bf16_ties, e_raw_argmax_equal=raw,
         e_nodes_with_tied_top_logits=tied, e_tie_rtol=LOGIT_RTOL, argmax_agreement_min=ARGMAX_AGREEMENT,
         exchange_ms_per_rank={p: [r["exchange_ms"][p] for r in results] for p in results[0].get("exchange_ms", {})},
         exchange_width=cfg.layer_dims[1], peak_memory_gb_per_rank=[r.get("peak_memory_gb") for r in results],
         profile_first_variant_per_rank=[r.get("profile") for r in results],
         launches_all_ranks=launches, timing=f"CUDA events after a group barrier, median of {HALO_REPS}; "
         f"{HALO_K} ranks share one card, so these are not multi-card times")
    require(ok, "halo", f"checks {checks}")
    return dict(launches=launches, train_launches=check_halo_train(results, plan, cfg, train, seconds),
                logits=logits, ref=ref, tracer=results[0]["obs"]["tracer"])


def check_halo_train(results: list, plan, cfg, train: dict, seconds: float) -> dict:
    """The `halo_train` line: every training variant's checks on every
    rank; returns each kernel's launches over all ranks' training steps."""
    from repro_torch.kernels import launch_counts

    variants = halo_train_variants()
    ref_losses = train["losses_bsr_quant_off"]
    rows_per_step = 2 * cfg.n_layers * plan.halo_rows_per_device     # forward and backward exchanges
    checks, per_variant = {}, {}
    launches = dict.fromkeys(launch_counts(), 0)

    def grad_errs(recs, ref):
        return {n: max(float(np.abs(rec["grads"][n] - ref[n]).max()) for rec in recs) / float(np.abs(ref[n]).max())
                for n in ref}

    for v in variants:
        recs = [r["train"][v.name] for r in results]
        for rec in recs:
            for name, n in rec["launches"].items():
                launches[name] += n
        expected = {k: n * HALO_TRAIN_STEPS for k, n in HALO_TRAIN_LAUNCHES[v.name].items()}
        checks[f"{v.name}_launches"] = all(rec["launches"] == expected for rec in recs)
        checks[f"{v.name}_wire_rows"] = all(rec["wire_rows"] == rows_per_step * HALO_TRAIN_STEPS for rec in recs)
        checks[f"{v.name}_finite"] = all(rec["finite"] for rec in recs)
        checks[f"{v.name}_steps"] = all(rec["steps_run"] == HALO_TRAIN_STEPS for rec in recs)
        checks[f"{v.name}_ranks_agree"] = all(rec["losses"] == recs[0]["losses"] for rec in recs)
        per_variant[v.name] = dict(
            backend=v.backend, payload=v.payload or "fp32", tables="split" if v.split else "combined",
            quant=v.quant, losses=recs[0]["losses"], launches_per_rank_per_step=HALO_TRAIN_LAUNCHES[v.name],
            wire_rows_per_rank_per_step=[rec["wire_rows"] / HALO_TRAIN_STEPS for rec in recs],
            wire_bytes_per_rank_per_step=[rec["wire_bytes"] / HALO_TRAIN_STEPS for rec in recs],
            step_ms_per_rank=[rec.get("step_ms") for rec in recs])
        if not v.quant:
            # The bf16 path's logits are bf16 (the fused layer's output), and
            # so is their cotangent: its reference rounds the logits alike.
            bf16 = v.payload == "bf16"
            errs = grad_errs(recs, train["grads_bsr_quant_off_bf16_logits" if bf16 else "grads_bsr_quant_off"])
            rtol = HALO_BF16_GRAD_RTOL if bf16 else HALO_GRAD_RTOL
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(recs[0]["losses"], ref_losses))
            per_variant[v.name].update(grad_rel_err_vs_unsharded=errs, grad_rtol=rtol,
                                       loss_max_rel_diff_vs_unsharded=loss_rel)
            if bf16:
                per_variant[v.name].update(
                    grad_reference="unsharded bsr, logits rounded to bf16",
                    grad_rel_err_vs_unsharded_fp32_logits=grad_errs(recs, train["grads_bsr_quant_off"]))
            checks[f"{v.name}_grads_vs_unsharded"] = all(e <= rtol for e in errs.values())
            if v.payload is None:
                per_variant[v.name]["loss_rtol"] = HALO_LOSS_RTOL
                checks[f"{v.name}_losses_vs_unsharded"] = loss_rel <= HALO_LOSS_RTOL
    bsr = [r["train"]["t4_bsr_quant_bf16"] for r in results]
    seg = [r["train"]["t4_segment_quant_bf16"] for r in results]
    errs = grad_errs(bsr, seg[0]["grads"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(bsr[0]["losses"], seg[0]["losses"]))
    per_variant["t4_bsr_quant_bf16"].update(grad_rel_err_vs_segment=errs, grad_rtol=HALO_BF16_GRAD_RTOL,
                                            loss_max_rel_diff_vs_segment=loss_rel, loss_rtol=HALO_QUANT_LOSS_RTOL)
    checks["t4_grads_bsr_vs_segment"] = all(e <= HALO_BF16_GRAD_RTOL for e in errs.values())
    checks["t4_losses_bsr_vs_segment"] = loss_rel <= HALO_QUANT_LOSS_RTOL
    ok = all(checks.values())
    emit("halo_train", ok=ok, checks=checks, reduced=HALO_REPS_REDUCED, ranks=HALO_K, steps=HALO_TRAIN_STEPS,
         optimizer=f"adamw(lr={HALO_TRAIN_LR})", seconds_halo_phase=seconds,
         wire_rows_per_rank_per_step_expected=rows_per_step, variants=per_variant,
         exchange_backward_ms_per_rank={p: [r["train"]["exchange_backward_ms"][p] for r in results]
                                        for p in results[0]["train"].get("exchange_backward_ms", {})},
         exchange_width=cfg.layer_dims[1],
         peak_memory_gb_per_rank=[r["train"].get("peak_memory_gb") for r in results],
         launches_all_ranks=launches, timing=f"step: host clock after a group barrier, median of {HALO_REPS} "
         f"after 2 warm-ups; exchange backward: CUDA events after a barrier, median of {HALO_REPS}; "
         f"{HALO_K} ranks share one card")
    require(ok, "halo_train", f"checks {checks}")
    return launches


# -------------------------------------------------------- hierarchical halo
def hier_variants():
    from repro_torch.launch.distributed_gcn import HaloVariant as V

    return V("h_fp32"), V("h_bf16", payload="bf16"), V("h_int8", payload="int8")


# Each hierarchical variant's flat twin in the halo phase (the same backend,
# wire and tables), and the launches per rank of one forward and one step:
# the flat path's (HALO_LAUNCHES, HALO_TRAIN_LAUNCHES): only the exchange differs.
HIER_FLAT_TWIN = {"h_fp32": "a_fp32", "h_bf16": "b_bf16", "h_int8": "d_int8"}
HIER_LAUNCHES = {name: HALO_LAUNCHES[twin] for name, twin in HIER_FLAT_TWIN.items()}
HIER_TRAIN_LAUNCHES = {"h_fp32": HALO_TRAIN_LAUNCHES["t1_fp32"]}


def overlap_enclosure(tracer) -> dict:
    """The reference's check on a trace of `overlap_timeline`: some
    ``halo.exchange.boundary_collective`` span encloses an
    ``overlap.interior_compute`` span, and every wire span is on the ``wire``
    track; with the spans' durations."""
    ev = tracer.events()
    wire = [e for e in ev if e.get("name") == "halo.exchange.boundary_collective"]
    interior = [e for e in ev if e.get("name") == "overlap.interior_compute"]
    tracks = {e["tid"]: e["args"]["name"] for e in ev if e["ph"] == "M" and e["name"] == "thread_name"}
    return dict(wire_spans=len(wire), interior_spans=len(interior),
                encloses=any(w["ts"] <= i["ts"] and i["ts"] + i["dur"] <= w["ts"] + w["dur"]
                             for w in wire for i in interior),
                on_wire_track=bool(wire) and all(tracks.get(e["tid"]) == "wire" for e in wire),
                wire_ms=[e["dur"] / 1e3 for e in wire], interior_ms=[e["dur"] / 1e3 for e in interior])


def run_hier(host: dict, halo: dict, flat: dict, train: dict, ckpt_dir: str, tuned_plan) -> dict:
    """The hierarchical (pod, model) exchange at Nell's widths: the same
    partition as the halo phase, as HIER_PODS pods × 2 ranks sharing the
    card (gloo), bsr, fp32 / bf16 / int8 wire; (h1) each variant against its
    flat twin and the unsharded forward, (h2) wire rows per phase against
    the plan, (h3) the sharded loss's gradient against the unsharded train
    phase's, (h4) HIER_TRAIN_STEPS AdamW steps against its losses (rank 0
    checkpoints the last into ``ckpt_dir``), then `overlap_timeline` on the
    2 × 2 groups. The same group then runs the fp32 forward on
    ``tuned_plan`` (the autotuned pod map) for the `autotune` line. Returns
    the launches of the forwards and of the steps, rank 0's trained
    parameters and its trace recorder, and for the `autotune` line the
    tuned plan's rank results, the default plan's h_fp32 logits, forward
    and per-phase exchange ms, and the unsharded reference."""
    from repro_torch.configs.coin_gcn import make_config
    from repro_torch.dist.halo import get_halo_plan, restore_node_array
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.distributed_gcn import HaloVariant, halo_ranks, rank_jobs
    from repro_torch.launch.mesh import GroupSpec, run_group
    from repro_torch.models.gcn import gcn_init

    t0 = time.perf_counter()
    plan = get_halo_plan(halo["part"], host["edge_index"], host["weights"], pods=HIER_PODS)
    plan_s = time.perf_counter() - t0
    cfg = make_config(dataset=DATASET)
    params = {k: v.numpy() for k, v in gcn_init(torch.Generator().manual_seed(SEED), cfg, device="cpu").items()}
    variants = hier_variants()
    jobs = rank_jobs(plan, host["features"], params, cfg.layer_dims, variants, quant=cfg.quant,
                     time_reps=HALO_REPS, labels=host["labels"], mask=host["train_mask"],
                     train_variants=(HaloVariant("h_fp32"),), steps=HIER_TRAIN_STEPS, lr=HALO_TRAIN_LR,
                     ckpt_dir=ckpt_dir, ckpt_every=HIER_TRAIN_STEPS, obs_trace=True)
    tuned_jobs = rank_jobs(tuned_plan, host["features"], params, cfg.layer_dims, (HaloVariant("h_fp32"),),
                           quant=cfg.quant, time_reps=HALO_REPS)
    spec = GroupSpec(k=plan.k, backend="gloo", devices=("cuda:0",), timeout_s=HALO_TIMEOUT_S)
    both = run_group(spec, halo_ranks, list(zip(jobs, tuned_jobs)))
    results, tuned = [r[0] for r in both], [r[1] for r in both]
    seconds = time.perf_counter() - t0
    ref, ref_scale = flat["ref"], float(np.abs(flat["ref"]).max())
    n_layers = cfg.n_layers
    checks, per_variant, restored = {}, {}, {}
    launches = dict.fromkeys(launch_counts(), 0)
    train_launches = dict.fromkeys(launch_counts(), 0)
    for v in variants:
        recs = [r["variants"][v.name] for r in results]
        logits = restore_node_array(plan, np.stack([rec["logits"] for rec in recs]))
        restored[v.name] = logits
        twin = flat["logits"][HIER_FLAT_TWIN[v.name]]
        for rec in recs:
            for name, n in rec["launches"].items():
                launches[name] += n
        diff_u, diff_f = logits - ref, logits - twin
        err_u, err_f = float(np.abs(diff_u).max()), float(np.abs(diff_f).max())
        if v.payload == "int8":
            rel_u = float(np.linalg.norm(diff_u) / np.linalg.norm(ref))
            rel_f = float(np.linalg.norm(diff_f) / np.linalg.norm(twin))
            checks[f"{v.name}_vs_unsharded"] = err_u < HALO_INT8_ABS and rel_u <= HALO_INT8_REL_L2
            checks[f"{v.name}_vs_flat"] = err_f < HALO_INT8_ABS and rel_f <= HALO_INT8_REL_L2
            bounds = dict(max_abs_bound=HALO_INT8_ABS, rel_l2_bound=HALO_INT8_REL_L2, rel_l2_vs_unsharded=rel_u,
                          rel_l2_vs_flat=rel_f)
        else:
            rtol = HALO_BF16_RTOL if v.payload == "bf16" else HALO_LOGIT_RTOL
            checks[f"{v.name}_vs_unsharded"] = err_u <= rtol * ref_scale
            checks[f"{v.name}_vs_flat"] = err_f <= rtol * ref_scale
            bounds = dict(rtol=rtol)
        checks[f"{v.name}_finite"] = all(rec["finite"] for rec in recs) and bool(np.isfinite(logits).all())
        checks[f"{v.name}_launches"] = all(rec["launches"] == HIER_LAUNCHES[v.name] for rec in recs)
        checks[f"{v.name}_wire_rows"] = all(
            rec["wire_rows_inter_pod"] == n_layers * plan.inter_pod_rows_per_device
            and rec["wire_rows_intra_pod"] == n_layers * plan.intra_pod_rows_per_device
            and rec["wire_rows"] == n_layers * plan.halo_rows_per_device for rec in recs)
        per_variant[v.name] = dict(
            payload=v.payload or "fp32", flat_twin=HIER_FLAT_TWIN[v.name], max_abs_err_vs_unsharded=err_u,
            max_abs_err_vs_flat=err_f, **bounds, launches_per_rank=[rec["launches"] for rec in recs],
            wire_rows_inter_pod_per_rank=[rec["wire_rows_inter_pod"] for rec in recs],
            wire_rows_intra_pod_per_rank=[rec["wire_rows_intra_pod"] for rec in recs],
            wire_bytes_per_rank=[rec["wire_bytes"] for rec in recs],
            forward_ms_per_rank=[rec.get("forward_ms") for rec in recs])
    checks["inter_pod_crossing_below_flat"] = plan.inter_pod_rows_crossing < plan.flat_inter_pod_rows_crossing
    # (h3), (h4): the training variant against the unsharded train phase.
    recs = [r["train"]["h_fp32"] for r in results]
    for rec in recs:
        for name, n in rec["launches"].items():
            train_launches[name] += n
    grads = train["grads_bsr_quant_off"]
    grad_err = {n: max(float(np.abs(rec["grads"][n] - grads[n]).max()) for rec in recs) / float(np.abs(grads[n]).max())
                for n in grads}
    ref_losses = train["losses_bsr_quant_off"][:HIER_TRAIN_STEPS]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(recs[0]["losses"], ref_losses))
    expected = {k: n * HIER_TRAIN_STEPS for k, n in HIER_TRAIN_LAUNCHES["h_fp32"].items()}
    checks.update(
        h3_grads_vs_unsharded=all(e <= HALO_GRAD_RTOL for e in grad_err.values()),
        h4_losses_vs_unsharded=len(recs[0]["losses"]) == HIER_TRAIN_STEPS and loss_rel <= HALO_LOSS_RTOL,
        h4_ranks_agree=all(rec["losses"] == recs[0]["losses"] for rec in recs),
        h4_launches=all(rec["launches"] == expected for rec in recs),
        h4_wire_rows=all(rec["wire_rows"] == 2 * n_layers * plan.halo_rows_per_device * HIER_TRAIN_STEPS
                         for rec in recs),
        h4_finite=all(rec["finite"] for rec in recs))
    ok = all(checks.values())
    emit("hier", ok=ok, checks=checks, reduced=HALO_REPS_REDUCED, pods=plan.n_pods, ranks_per_pod=plan.k_model,
         group=spec.describe(),
         shared_card="cuda:0", wire="gloo through the host; phase 1 over each rank's pod group, phase 2 over "
         "its model group", seconds=seconds, plan_host_build_s=plan_s, s_loc=plan.s_loc, s_rem=plan.s_rem,
         block_rows=plan.block_rows, rows_per_rank_per_exchange=dict(
             inter_pod=plan.inter_pod_rows_per_device, intra_pod=plan.intra_pod_rows_per_device,
             total=plan.halo_rows_per_device, flat=HALO_K * plan.s_max),
         inter_pod_rows_crossing=dict(hierarchical=plan.inter_pod_rows_crossing,
                                      flat=plan.flat_inter_pod_rows_crossing),
         exchanges_per_forward=n_layers, max_abs_logit_unsharded=ref_scale, variants=per_variant,
         exchange_ms_per_rank={p: [r["exchange_ms"][p] for r in results] for p in results[0].get("exchange_ms", {})},
         exchange_phase_ms_per_rank={p: [r["exchange_phase_ms"][p] for r in results]
                                     for p in results[0].get("exchange_phase_ms", {})},
         exchange_width=cfg.layer_dims[1],
         train=dict(steps=HIER_TRAIN_STEPS, optimizer=f"adamw(lr={HALO_TRAIN_LR})", losses=recs[0]["losses"],
                    reference_losses=ref_losses, loss_max_rel_diff=loss_rel, loss_rtol=HALO_LOSS_RTOL,
                    grad_rel_err_vs_unsharded=grad_err, grad_rtol=HALO_GRAD_RTOL,
                    launches_per_rank_per_step=HIER_TRAIN_LAUNCHES["h_fp32"],
                    step_ms_per_rank=[rec.get("step_ms") for rec in recs],
                    exchange_backward_ms_per_rank={p: [r["train"]["exchange_backward_ms"][p] for r in results]
                                                   for p in results[0]["train"].get("exchange_backward_ms", {})},
                    checkpoint=f"rank 0, step {HIER_TRAIN_STEPS}"),
         peak_memory_gb_per_rank=[r.get("peak_memory_gb") for r in results],
         profile_first_variant_per_rank=[r.get("profile") for r in results],
         launches_all_ranks=launches, train_launches_all_ranks=train_launches,
         timing=f"CUDA events after a group barrier, median of {HALO_REPS}; step: host clock after a barrier; "
                f"{plan.k} ranks share one card, so these are not multi-card times")
    require(ok, "hier", f"checks {checks}")
    return dict(launches=launches, train_launches=train_launches, params=recs[0]["params"],
                tracer=results[0]["obs"]["tracer"], plan=plan, tuned=tuned, ref=ref, n_layers=n_layers,
                logits_h_fp32=restored["h_fp32"], forward_ms_h_fp32=per_variant["h_fp32"]["forward_ms_per_rank"],
                exchange_phase_ms={p: [r["exchange_phase_ms"][p] for r in results]
                                   for p in results[0].get("exchange_phase_ms", {})})


def measure_engines(data: dict, totals: dict) -> dict:
    """(d) of the `autotune` line, while the unsharded table is on the card:
    the H100 planner's terms for unsharded Nell (k = 1) beside the measured
    quant-off forward, and the inputs of `BACKEND_EFFICIENCY`: one fp32
    aggregation Ã·Z at Nell per width in AUTOTUNE_WIDTHS through K1 and
    through the segment path (gather + `index_add_`, as the segment backend
    aggregates), each as the cost model's multiplies (bsr: valid tiles ·
    128² · F; segment: E · F) over `PEAK_FLOPS` × its CUDA-event time. The
    two outputs' largest difference is reported beside them. Not gated."""
    from repro_torch.core import autotune as at
    from repro_torch.core.planner import GPUHardware, coin_objective_gpu
    from repro_torch.graph.ops import aggregate_padded
    from repro_torch.kernels import bsr_spmm as k1

    vals, cols, lens, pg, n = data["vals"], data["cols"], data["lens"], data["pg"], data["n"]
    spec, nnz, e = data["spec"], int(lens.sum()), pg.n_real_edges
    dims = (spec.n_features, spec.hidden, spec.n_labels)
    hw = GPUHardware()
    compute_s, hbm_s, link_s = coin_objective_gpu(n, e, dims, 1, hw)
    generator = torch.Generator().manual_seed(SEED + 3)
    engines = {}
    with torch.inference_mode():
        for f in AUTOTUNE_WIDTHS:
            z = torch.randn((cols.shape[0] * 128, f), generator=generator).to(vals.device)
            out, ref = k1.bsr_spmm(vals, cols, lens, z)[:n], aggregate_padded(z[:n], pg.senders, pg.receivers, n,
                                                                             pg.edge_weight)
            err, scale = max_err(out, ref)
            k1_ms = cuda_ms(lambda: k1.bsr_spmm(vals, cols, lens, z))
            seg_ms = cuda_ms(lambda: aggregate_padded(z[:n], pg.senders, pg.receivers, n, pg.edge_weight))
            bsr_mult, seg_mult = float(nnz) * 128 * 128 * f, float(e) * f
            engines[f"F{f}"] = dict(
                k1_ms=k1_ms, segment_ms=seg_ms, bsr_multiplies=bsr_mult, segment_multiplies=seg_mult,
                bsr=bsr_mult / (at.PEAK_FLOPS * k1_ms / 1e3), segment=seg_mult / (at.PEAK_FLOPS * seg_ms / 1e3),
                max_abs_diff_k1_vs_segment=err, max_abs_segment=scale)
            del z, out, ref
    return dict(planner=dict(hardware=dataclasses.asdict(hw), k=1, layer_dims=list(dims), n_nodes=n, n_edges=e,
                             compute_ms=compute_s * 1e3, hbm_ms=hbm_s * 1e3, link_ms=link_s * 1e3,
                             measured_forward_bsr_quant_off_ms=totals["forward_bsr_noquant_ms"]),
                backend_efficiency=engines, peak_flops=at.PEAK_FLOPS,
                backend_efficiency_in_use=dict(at.BACKEND_EFFICIENCY))


def prepare_autotune(host: dict, halo: dict) -> dict:
    """(a) and (b) of the `autotune` line, on the host. (a) The CLI
    (`repro_torch.launch.autotune`) at its defaults: the JSON record it
    writes, its exit code and seconds. (b) The halo phase's partition of
    Nell as HIER_PODS pods: the quotient-graph pod map, the tuned plan
    beside the default one (the hier phase's, from the plan cache),
    `exchange_accounting`'s predicted fields against the measured ones on
    both plans for each cell of AUTOTUNE_CELLS at the exchanged width, and
    `autotune_config`'s choice there."""
    import types

    from repro_torch.configs.coin_gcn import make_config
    from repro_torch.core.autotune import BLOCK_GRID, BoundaryIndex, autotune_config, map_parts_to_pods
    from repro_torch.core.energy import model_from_gcn
    from repro_torch.dist.halo import build_halo_plan, get_halo_plan, plan_blocked_shape
    from repro_torch.launch import autotune as cli
    from repro_torch.launch.dryrun import exchange_accounting

    with tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_") as tmp:
        path = pathlib.Path(tmp) / "autotune.json"
        t0 = time.perf_counter()
        rc = cli.main(["--out", str(path)])
        cli_s = time.perf_counter() - t0
        rec = json.loads(path.read_text())
    md, mt = rec["measured"]["default"], rec["measured"]["autotuned"]

    part, edges, w = halo["part"], host["edge_index"], host["weights"]
    dims = make_config(dataset=DATASET).layer_dims
    t0 = time.perf_counter()
    index = BoundaryIndex(part, edges)
    pod_map = map_parts_to_pods(part, edges, HIER_PODS, index=index)
    map_s = time.perf_counter() - t0
    default = get_halo_plan(part, edges, w, pods=HIER_PODS)
    t0 = time.perf_counter()
    tuned = build_halo_plan(part, edges, w, axes=("pod", "model"), pods=HIER_PODS, pod_map=pod_map)
    plan_s = time.perf_counter() - t0
    calibration = {}
    for name, plan in (("default", default), ("tuned", tuned)):
        for payload, overlap in AUTOTUNE_CELLS:
            cell = types.SimpleNamespace(comm="halo", halo_plan=plan, halo_payload=payload, halo_overlap=overlap)
            acc = exchange_accounting(cell, types.SimpleNamespace(d_feat=dims[1]))
            pred = acc["predicted"]
            calibration[f"{name}_{payload or 'fp32'}{'_overlap' if overlap else ''}"] = {
                f: [pred[f], acc[f]] for f in sorted(pred.keys() & acc.keys()) if pred[f] != acc[f]}
    t0 = time.perf_counter()
    nnz = {b: plan_blocked_shape(default, block=b)["nnz_blocks"] for b in BLOCK_GRID}
    result = autotune_config(part, edges, pods=HIER_PODS, d_feat=dims[1], layer_dims=dims, nnz_blocks_for=nnz,
                             energy_model=model_from_gcn(part.n_nodes, dims))
    tune_s = time.perf_counter() - t0
    terms = ("compute_s", "wire_s", "noc_latency_s", "noc_energy_j", "coin_energy_j", "objective_s")

    def geometry(plan):
        return dict(s_loc=plan.s_loc, s_rem=plan.s_rem, halo_rows_per_rank=plan.halo_rows_per_device,
                    inter_pod_rows_per_rank=plan.inter_pod_rows_per_device,
                    intra_pod_rows_per_rank=plan.intra_pod_rows_per_device,
                    inter_pod_rows_crossing=plan.inter_pod_rows_crossing)

    return dict(
        plan=tuned,
        cli=dict(rc=rc, host_s=cli_s, graph=rec["graph"], config=rec["config"], history=rec["history"],
                 inter_pod_rows_crossing=[md["inter_pod_rows_crossing"], mt["inter_pod_rows_crossing"]],
                 halo_rows_per_device=[md["halo_rows_per_device"], mt["halo_rows_per_device"]],
                 improvement=rec["improvement"], calibration_mismatches=rec["calibration_mismatches"]),
        nell=dict(pods=HIER_PODS, k=part.k, pod_map=pod_map.tolist(), map_host_s=map_s, tuned_plan_host_s=plan_s,
                  default=geometry(default), tuned=geometry(tuned), d_feat=dims[1],
                  calibration_mismatches=calibration, nnz_blocks_for=nnz,
                  autotune_config=dict(config=dataclasses.asdict(result.config), history=result.history,
                                       baseline={t: result.baseline[t] for t in terms},
                                       chosen={t: result.predicted[t] for t in terms}, host_s=tune_s)))


def run_autotune_line(tune: dict, hier: dict, engines: dict) -> dict:
    """The `autotune` line: (a) and (b) from `prepare_autotune`; (c) the 2 ×
    2 bsr fp32 forward on the tuned plan, run by the hier phase's group after
    its own work (`halo_ranks`): its restored logits against the default
    plan's (the hier phase's h_fp32) and the unsharded forward under the
    hier phase's rule, and the wire rows each rank counted per phase against
    the tuned plan's; forward and per-phase exchange ms for both maps (4
    ranks share one card and gloo has no slow tier: no gate); (d) from
    `measure_engines`. Returns each kernel's launches in (c), all ranks."""
    from repro_torch.dist.halo import restore_node_array
    from repro_torch.kernels import launch_counts

    plan, cli, nell = tune["plan"], tune["cli"], tune["nell"]
    results = hier["tuned"]
    recs = [r["variants"]["h_fp32"] for r in results]
    logits = restore_node_array(plan, np.stack([rec["logits"] for rec in recs]))
    ref, default = hier["ref"], hier["logits_h_fp32"]
    scale = float(np.abs(ref).max())
    err_default, err_unsharded = float(np.abs(logits - default).max()), float(np.abs(logits - ref).max())
    n_layers = hier["n_layers"]
    launches = dict.fromkeys(launch_counts(), 0)
    for rec in recs:
        for name, n in rec["launches"].items():
            launches[name] += n
    checks = dict(
        a_cli_exit_code=cli["rc"] == 0, a_cli_calibration=cli["calibration_mismatches"] == {},
        b_tuned_crossing_le_default=nell["tuned"]["inter_pod_rows_crossing"]
        <= nell["default"]["inter_pod_rows_crossing"],
        b_calibration=all(m == {} for m in nell["calibration_mismatches"].values()),
        c_vs_default=err_default <= HALO_LOGIT_RTOL * scale,
        c_vs_unsharded=err_unsharded <= HALO_LOGIT_RTOL * scale,
        c_finite=all(rec["finite"] for rec in recs) and bool(np.isfinite(logits).all()),
        c_shape=logits.shape == ref.shape,
        c_launches=all(rec["launches"] == HIER_LAUNCHES["h_fp32"] for rec in recs),
        c_wire_rows=all(rec["wire_rows_inter_pod"] == n_layers * plan.inter_pod_rows_per_device
                        and rec["wire_rows_intra_pod"] == n_layers * plan.intra_pod_rows_per_device
                        and rec["wire_rows"] == n_layers * plan.halo_rows_per_device for rec in recs))
    ok = all(checks.values())
    emit("autotune", ok=ok, checks=checks, cli=cli, nell=nell,
         forward=dict(variant="h_fp32 (bsr, fp32 wire, combined table)", pods=plan.n_pods, ranks_per_pod=plan.k_model,
                      max_abs_err_vs_default=err_default, max_abs_err_vs_unsharded=err_unsharded,
                      rtol=HALO_LOGIT_RTOL, max_abs_logit_unsharded=scale,
                      launches_per_rank=[rec["launches"] for rec in recs],
                      wire_rows_inter_pod_per_rank=[rec["wire_rows_inter_pod"] for rec in recs],
                      wire_rows_intra_pod_per_rank=[rec["wire_rows_intra_pod"] for rec in recs],
                      expected_wire_rows_per_forward=dict(inter_pod=n_layers * plan.inter_pod_rows_per_device,
                                                          intra_pod=n_layers * plan.intra_pod_rows_per_device),
                      forward_ms_per_rank=dict(default=hier["forward_ms_h_fp32"],
                                               tuned=[rec.get("forward_ms") for rec in recs]),
                      exchange_phase_ms_per_rank=dict(default=hier["exchange_phase_ms"], tuned={
                          p: [r["exchange_phase_ms"][p] for r in results]
                          for p in results[0].get("exchange_phase_ms", {})}),
                      launches_all_ranks=launches,
                      timing=f"CUDA events after a group barrier, median of {HALO_REPS}; {plan.k} ranks share one "
                             f"card and the wire is gloo through the host, so no time here is a multi-card time"),
         **engines)
    require(ok, "autotune", f"checks {checks}")
    return launches



def run_elastic(host: dict, halo: dict, hier: dict, ckpt_dir: str, device: torch.device) -> None:
    """The contract of `repro_torch.train.elastic` at Nell's partition: a
    pure resize keeps the cached plan (0 evictions, the same object); a
    model-degree halving from HALO_K to HALO_K / 2 evicts, the partition is
    rebuilt at the new k, and a group of that many ranks restores the
    hierarchical run's rank-0 checkpoint: its first loss equals the
    unsharded loss at the checkpointed parameters."""
    from repro_torch.configs.coin_gcn import make_config
    from repro_torch.core.partition import partition_graph
    from repro_torch.dist.halo import get_halo_plan, plan_cache_stats
    from repro_torch.graph.structure import GraphData, to_padded
    from repro_torch.launch.distributed_gcn import HaloVariant, halo_train_rank, rank_jobs
    from repro_torch.launch.mesh import GroupSpec, run_group
    from repro_torch.models.gcn import GCNConfig, gcn_init, gcn_loss
    from repro_torch.train.elastic import elastic_replan

    t0 = time.perf_counter()
    edges, weights = host["edge_index"], host["weights"]
    n = len(host["labels"])
    stats0 = plan_cache_stats()
    keep = elastic_replan(ELASTIC_HEALTHY[0], HALO_K)
    same = get_halo_plan(halo["part"], edges, weights) is halo["plan"]
    stats1 = plan_cache_stats()
    shrink = elastic_replan(ELASTIC_HEALTHY[1], HALO_K)
    stats2 = plan_cache_stats()
    k_new = shrink.shape[1]
    part = partition_graph(n, edges, k_new, method="bfs", seed=0, refine=True)
    plan = get_halo_plan(part, edges, weights)
    replan_s = time.perf_counter() - t0
    cfg = make_config(dataset=DATASET)
    params = {k: v.numpy() for k, v in gcn_init(torch.Generator().manual_seed(SEED), cfg, device="cpu").items()}
    jobs = rank_jobs(plan, host["features"], params, cfg.layer_dims, (), labels=host["labels"],
                     mask=host["train_mask"], train_variants=(HaloVariant("e_fp32"),), steps=HIER_TRAIN_STEPS + 1,
                     lr=HALO_TRAIN_LR, ckpt_dir=ckpt_dir, ckpt_every=10 * HIER_TRAIN_STEPS)
    spec = GroupSpec(k=k_new, backend="gloo", devices=("cuda:0",), timeout_s=HALO_TIMEOUT_S)
    recs = [r["train"]["e_fp32"] for r in run_group(spec, halo_train_rank, jobs)]
    first = recs[0]["losses"][0]
    # The unsharded loss (segment path on the card) at rank 0's checkpointed parameters.
    pg = to_padded(GraphData(n, edges), weights=weights, device=device)
    with torch.inference_mode():
        ref = float(gcn_loss({k: torch.from_numpy(v).to(device) for k, v in hier["params"].items()},
                             torch.from_numpy(host["features"]).to(device).float(), pg.senders, pg.receivers,
                             pg.edge_weight, torch.from_numpy(host["labels"]).to(device),
                             torch.from_numpy(host["train_mask"]).to(device),
                             GCNConfig(layer_dims=cfg.layer_dims, backend="segment")))
    del pg
    rel = abs(first - ref) / abs(ref)
    checks = dict(
        resize_keeps_model_shards=tuple(keep.shape) == (ELASTIC_HEALTHY[0] // HALO_K, HALO_K),
        resize_keeps_plan=same and stats1["evictions"] == stats0["evictions"],
        halving_evicts=stats2["evictions"] >= stats0["evictions"] + 1,
        halving_model_shards=k_new == HALO_K // 2 and plan.k == k_new,
        restored_on_every_rank=all(rec["resumed"] and rec["step"] == HIER_TRAIN_STEPS + 1 for rec in recs),
        ranks_agree=all(rec["losses"] == recs[0]["losses"] for rec in recs),
        first_loss_vs_unsharded=rel <= HALO_LOSS_RTOL)
    ok = all(checks.values())
    emit("elastic", ok=ok, checks=checks, healthy=list(ELASTIC_HEALTHY), model_shards_before=HALO_K,
         resize_shape=list(keep.shape), halving_shape=list(shrink.shape),
         plan_cache=dict(before=stats0, after_resize=stats1, after_halving=stats2),
         new_plan=dict(k=plan.k, n_local=plan.n_local, s_max=plan.s_max, halo_rows_per_rank=plan.halo_rows_per_device),
         group=spec.describe(), checkpoint=f"the hier phase's rank 0, step {HIER_TRAIN_STEPS}",
         first_loss=first, unsharded_loss_at_checkpoint=ref, rel_diff=rel, loss_rtol=HALO_LOSS_RTOL,
         losses=recs[0]["losses"], replan_host_s=replan_s, seconds=time.perf_counter() - t0)
    require(ok, "elastic", f"checks {checks}")


def run_serve_graph(host: dict, device: torch.device) -> None:
    """`GraphBatcher` serving at Nell on the card, with the reference serve
    CLI's defaults (batch_seeds 8, fanout 4, cache 256, 4 parts; quant off,
    as the engine forces it): SERVE_QUERIES degree-weighted queries in
    waves, a cache-off twin serving the same stream; halfway, the CLI's
    churn burst (8 deltas of 2 % of the edges) to both engines and to a
    mirrored `DeltaPlanner` under a `RelocalizePolicy`, whose fires the
    engines adopt. Checks: cache on = cache off (SERVE_LOGIT_RTOL of max
    |logit|) before and after the burst, and = a fresh cache-less engine
    on the mutated graph after it; strictly fewer sampled nodes + edges
    per query with the cache; one forward shape per engine; the policy
    fired."""
    from repro_torch.configs.coin_gcn import make_config
    from repro_torch.core.partition import partition_graph
    from repro_torch.dist.delta import DeltaPlanner, RelocalizePolicy
    from repro_torch.graph.structure import GraphData
    from repro_torch.launch.serve import churn_delta
    from repro_torch.models.gcn import gcn_init
    from repro_torch.serve.graph import GraphBatcher, hot_query_stream

    t_phase = time.perf_counter()
    ei = host["raw_edge_index"]
    n = len(host["labels"])
    graph = GraphData(n, ei, features=np.asarray(host["features"], np.float32), labels=host["labels"])
    cfg = make_config(dataset=DATASET)
    params = gcn_init(torch.Generator().manual_seed(SEED), cfg, device=device)
    part = partition_graph(n, ei, SERVE_PARTS, method="bfs", seed=SEED, refine=True)

    def engine(cache: int, g=graph, partition=part):
        return GraphBatcher(params, g, cfg, batch_seeds=SERVE_BATCH_SEEDS, fanout=SERVE_FANOUT,
                            cache_capacity=cache, partition=partition, seed=SEED, device=device)

    on, off = engine(SERVE_CACHE), engine(0)
    planner = DeltaPlanner(part, ei, graph_key="serve-nell",
                           relocalize_policy=RelocalizePolicy(**SERVE_RELOCALIZE))
    nodes = hot_query_stream(graph, SERVE_QUERIES, seed=SEED + 1)
    half = SERVE_QUERIES // 2
    serve_s = {"on": 0.0, "off": 0.0}

    def serve(engines: dict, queue) -> dict:
        """Serve ``queue`` in waves on every engine; the logits per position."""
        got = {name: [] for name in engines}
        for i in range(0, len(queue), SERVE_WAVE):
            for name, e in engines.items():
                t0 = time.perf_counter()
                start = len(e.finished)
                for v in queue[i:i + SERVE_WAVE]:
                    e.submit(int(v))
                e.run_until_drained()
                serve_s[name] = serve_s.get(name, 0.0) + time.perf_counter() - t0
                got[name] += [q.logits for q in sorted(e.finished[start:], key=lambda q: q.qid)]
        return {name: np.stack(v) for name, v in got.items()}

    def rel_err(a, b) -> float:
        return float(np.abs(a - b).max() / np.abs(b).max())

    first = serve({"on": on, "off": off}, nodes[:half])
    burst = []
    churn = np.random.default_rng(SEED + 2)
    for _ in range(SERVE_CHURN_ROUNDS):
        delta = churn_delta(planner, churn, n)
        t0 = time.perf_counter()
        eng = on.apply_graph_delta(delta)
        engine_ms = (time.perf_counter() - t0) * 1e3
        off.apply_graph_delta(delta)
        rep = planner.apply(delta)
        fired = rep["relocalized"] is not None
        if fired:
            on.adopt_partition(planner.part)
            off.adopt_partition(planner.part)
        burst.append(dict(inserts=rep["inserts"], deletes=rep["deletes"], apply_ms=rep["apply_ms"],
                          drift_ratio=rep["drift"]["drift_ratio"], fired=fired,
                          relocalize_ms=rep["relocalized"]["relocalize_ms"] if fired else None,
                          apply_graph_delta_ms=engine_ms, residents_before=eng["residents_before"],
                          residents_dropped=eng["residents_dropped"]))
    second = serve({"on": on, "off": off}, nodes[half:])
    fresh = engine(0, g=on.graph, partition=planner.part)
    fresh_out = serve({"fresh": fresh}, nodes[half:])["fresh"]
    # The card's share of one wave of the cache-on engine (host sampling, the
    # forward's few small kernels), outside the counted stream.
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.trace import device_time_summary

    probe = engine(SERVE_CACHE, g=on.graph, partition=planner.part)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for v in nodes[:SERVE_WAVE]:
            probe.submit(int(v))
        probe.run_until_drained()
        torch.cuda.synchronize()
    wave_profile = device_time_summary(list(prof.events()), 1, top=6)
    s_on, s_off = on.stats(), off.stats()
    fires = sum(b["fired"] for b in burst)
    errs = dict(before=rel_err(first["on"], first["off"]), after=rel_err(second["on"], second["off"]),
                after_vs_fresh=rel_err(second["on"], fresh_out))
    checks = dict(
        cache_on_equals_off_before=errs["before"] <= SERVE_LOGIT_RTOL,
        cache_on_equals_off_after=errs["after"] <= SERVE_LOGIT_RTOL,
        cache_on_equals_fresh_after=errs["after_vs_fresh"] <= SERVE_LOGIT_RTOL,
        fewer_sampled_with_cache=(on.nodes_sampled + on.edges_sampled) < (off.nodes_sampled + off.edges_sampled),
        one_forward_shape=on.traces == off.traces == fresh.traces == 1,
        policy_fired=fires >= 1,
        finite=all(np.isfinite(v).all() for v in (*first.values(), *second.values(), fresh_out)),
        served_all=s_on["queries"] == s_off["queries"] == SERVE_QUERIES)
    ok = all(checks.values())
    c = s_on["cache"]
    emit("serve_graph", ok=ok, checks=checks, queries=SERVE_QUERIES, wave=SERVE_WAVE,
         batch_seeds=SERVE_BATCH_SEEDS, fanout=SERVE_FANOUT, cache_capacity=SERVE_CACHE, parts=SERVE_PARTS,
         n_nodes=n, n_edges=int(ei.shape[1]), micro_batches=s_on["micro_batches"], traces=s_on["traces"],
         p50_ms=s_on["p50_ms"], p99_ms=s_on["p99_ms"], p50_ms_cache_off=s_off["p50_ms"],
         p99_ms_cache_off=s_off["p99_ms"], queries_per_s=SERVE_QUERIES / serve_s["on"],
         queries_per_s_cache_off=SERVE_QUERIES / serve_s["off"],
         nodes_per_query=dict(on=s_on["nodes_per_query"], off=s_off["nodes_per_query"]),
         edges_per_query=dict(on=s_on["edges_per_query"], off=s_off["edges_per_query"]),
         hit_rate=c["hit_rate"], hits=c["hits"], misses=c["misses"], residents=c["resident"],
         evictions=c["evictions"], rows_saved=c["rows_saved"], bytes_saved=c["bytes_saved"],
         residents_dropped=c["nodes_dropped"], foreign_rows=s_on["foreign_rows"],
         max_rel_logit_diff=errs, logit_rtol=SERVE_LOGIT_RTOL, policy=SERVE_RELOCALIZE, fires=fires,
         drift_readings=[b["drift_ratio"] for b in burst], burst=burst,
         residual_drift=planner.locality_drift()["drift_ratio"],
         profile_one_wave=dict(micro_batches=probe.micro_batches, **wave_profile),
         timing="host clock; p50/p99 per query from submit to logits, a wave submitted at once",
         seconds=time.perf_counter() - t_phase)
    require(ok, "serve_graph", f"checks {checks}")


def prepare_delta(data: dict, halo: dict) -> dict:
    """The delta phase's script and its unsharded references, made while
    the unsharded table is still here: `mutation_script` on a replica of
    the ranks' planner (flat and 2 × 2 plans of the plan phase's
    partition), then, on the data phase's global table patched through the
    same deltas by `delta_update_blocked_adjacency` (in the locality
    order), the unsharded bsr forward (fp32, quant off) at every stage
    and the AdamW losses across the structural delta."""
    from repro_torch.configs.coin_gcn import make_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.dist.delta import GraphDelta, apply_delta_to_graph, delta_update_blocked_adjacency
    from repro_torch.graph.structure import GraphData, permute_edge_index, restore_rows, to_padded
    from repro_torch.launch.distributed_gcn import mutation_script
    from repro_torch.models.gcn import gcn_forward, gcn_init, gcn_loss
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import adamw

    t0 = time.perf_counter()
    host, device = data["host"], data["x"].device
    script = mutation_script(halo["part"], host["edge_index"], host["weights"], pods=HIER_PODS, seed=SEED,
                             patch_ops=DELTA_PATCH_OPS, members=DELTA_MEMBERS, max_edges=DELTA_MAX_EDGES,
                             policy=DELTA_RELOCALIZE, max_burst=DELTA_MAX_BURST, graph_key="delta-nell")
    script_s = time.perf_counter() - t0
    perm = host["perm"]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    ba = data["ba"]
    cur = GraphData(data["n"], permute_edge_index(perm, host["edge_index"]), edge_weight=host["weights"])
    cfg = dataclasses.replace(make_config(dataset=DATASET), backend="bsr", quant=QuantConfig(enabled=False))
    params = gcn_init(torch.Generator().manual_seed(SEED), cfg, device=device)
    mask = (~data["test"]).float()
    burst, fired = script["burst"], script["fired_at"]
    steps_between = {"v0": (), "delta1": script["deltas"][:1], "delta2": script["deltas"][1:],
                     "relocalized": burst[:fired], "compact": burst[fired:]}
    refs, patch_ms, widths, batches = {}, [], [], {}
    for name, deltas in steps_between.items():
        for d in deltas:
            dp = GraphDelta(edge_inserts=inv[d.edge_inserts], edge_deletes=inv[d.edge_deletes], insert_w=d.insert_w)
            cur = apply_delta_to_graph(cur, dp)
            t1 = time.perf_counter()
            delta_update_blocked_adjacency(ba, cur.edge_index, cur.edge_weight, dp)
            patch_ms.append((time.perf_counter() - t1) * 1e3)
        widths.append(ba.max_nnzb)
        pg = to_padded(cur, device=device)
        adjacency = ba.arrays(device=device)
        with torch.inference_mode():
            logits = gcn_forward(params, data["x"], pg.senders, pg.receivers, pg.edge_weight, cfg, adjacency=adjacency)
        refs[name] = restore_rows(perm, logits.cpu().numpy())
        if name in ("delta1", "delta2"):
            batches[name] = dict(s=pg.senders, r=pg.receivers, w=pg.edge_weight, adj=adjacency)
        else:
            del adjacency
        del pg
        torch.cuda.empty_cache()

    def loss(p, b):
        return gcn_loss(p, data["x"], b["s"], b["r"], b["w"], data["labels"], mask, cfg, adjacency=b["adj"])

    tr = Trainer(loss, adamw(HALO_TRAIN_LR), params, TrainerConfig(log_every=1 << 30))
    losses = []
    for name, steps in zip(("delta1", "delta2"), DELTA_TRAIN_STEPS):
        losses += tr.fit(iter(lambda b=batches[name]: b, None), max_steps=tr.step + steps)
    del batches, tr
    data.pop("ba")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(script=script, part=halo["part"], refs=refs, losses=losses, script_s=script_s,
                global_patch_ms=patch_ms,
                global_widths=widths, prepare_s=time.perf_counter() - t0)


def run_delta(host: dict, prep: dict) -> dict:
    """The mutating graph on HALO_K ranks sharing the card (gloo): every rank
    keeps its own `DeltaPlanner` replica and rank tables (`delta_rank`) and
    runs the script of `prepare_delta`. Checks each stage's flat and 2 × 2
    forwards against the unsharded bsr forward on the same edges
    (HALO_LOGIT_RTOL), the ranks' plan checksums against each other and
    the replica's, which path kept each table (patch, then rebuild on the
    structural delta), rank 0's tables against fresh builds, K1 and K2 on
    its patched table against their plain versions and with NaN padding,
    the training losses across the structural delta (HALO_LOSS_RTOL), the
    policy's fire with fewer executed tiles after it, the moved blocks
    bit-exact, and `compact`. Returns each kernel's launches over the
    forwards and over the training steps of all ranks."""
    from repro_torch.configs.coin_gcn import make_config
    from repro_torch.dist.halo import node_mask, relocate_node_array, restore_node_array
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.distributed_gcn import DeltaJob, array_checksum, delta_rank
    from repro_torch.launch.mesh import GroupSpec, run_group
    from repro_torch.models.gcn import gcn_init

    t0 = time.perf_counter()
    script = prep["script"]
    stages = script["stages"]
    cfg = make_config(dataset=DATASET)
    params = {k: v.numpy() for k, v in gcn_init(torch.Generator().manual_seed(SEED), cfg, device="cpu").items()}
    layout0 = stages["v0"]["layout"]
    xb = relocate_node_array(layout0, host["features"])
    lb = relocate_node_array(layout0, np.asarray(host["labels"], np.int64))
    mb = relocate_node_array(layout0, host["train_mask"]) * node_mask(layout0)
    jobs = [DeltaJob(part=prep["part"], edge_index=host["edge_index"], w=host["weights"], x=xb[r], labels=lb[r],
                     mask=mb[r], params=params, layer_dims=cfg.layer_dims, deltas=script["deltas"],
                     train_steps=DELTA_TRAIN_STEPS, lr=HALO_TRAIN_LR, pods=HIER_PODS, policy=DELTA_RELOCALIZE,
                     burst=script["burst"], time_reps=HALO_REPS,
                     graph_key="delta-nell")
            for r in range(HALO_K)]
    del xb
    spec = GroupSpec(k=HALO_K, backend="gloo", devices=("cuda:0",), timeout_s=HALO_TIMEOUT_S)
    results = run_group(spec, delta_rank, jobs)
    seconds = time.perf_counter() - t0
    names = [s["name"] for s in results[0]["stages"]]
    checks, per_stage = {}, {}
    launches = dict.fromkeys(launch_counts(), 0)
    train_launches = dict.fromkeys(launch_counts(), 0)
    for name in names:
        recs = [next(s for s in r["stages"] if s["name"] == name) for r in results]
        st, ref = stages[name], prep["refs"][name]
        scale = float(np.abs(ref).max())
        errs = {}
        for sch in recs[0]["logits"]:
            got = restore_node_array(st["layout"], np.stack([rec["logits"][sch] for rec in recs]))
            errs[sch] = float(np.abs(got - ref).max())
            checks[f"{name}_{sch}_vs_unsharded"] = got.shape == ref.shape and errs[sch] <= HALO_LOGIT_RTOL * scale
        for rec in recs:
            for k_name, v in rec["launches"].items():
                launches[k_name] += v
        expect = {k_name: n * len(recs[0]["logits"]) for k_name, n in DELTA_LAUNCHES_PER_FORWARD.items()}
        checks[f"{name}_launches"] = all(rec["launches"] == expect for rec in recs)
        checks[f"{name}_replicas_agree"] = {rec["checksum"] for rec in recs} == {st["checksum"]}
        checks[f"{name}_rank0_tables_fresh"] = all(c["same"] for c in recs[0]["table_check"].values())
        if "kernels" in recs[0]:
            checks[f"{name}_rank0_kernels"] = all(c["ok"] for c in recs[0]["kernels"].values())
        per_stage[name] = dict(
            version=recs[0]["version"], pads=recs[0]["pads"], max_abs_err_vs_unsharded=errs, max_abs_logit=scale,
            tables_per_rank=[rec["tables"] for rec in recs], launches_per_rank=[rec["launches"] for rec in recs],
            forward_ms_per_rank=[rec.get("forward_ms") for rec in recs],
            rank0_table_check=recs[0]["table_check"], rank0_kernels=recs[0].get("kernels"))
    reps = script["reports"]
    checks["tile_patch_delta"] = not reps[0]["structural"] and all(
        r["reports"][0]["blocked_patched"] > 0 for r in results)
    checks["tile_patch_path_ran"] = all(
        t["last"] in ("patched", "unchanged") for r in results for t in r["stages"][1]["tables"].values()) and any(
        t["last"] == "patched" for r in results for t in r["stages"][1]["tables"].values())
    checks["structural_delta"] = reps[1]["structural"] and all(
        r["stages"][2]["tables"]["flat"]["last"] == "rebuilt" for r in results)
    train = [[v for t in r["train"] for v in t["losses"]] for r in results]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(train[0], prep["losses"])]
    checks["losses_vs_unsharded"] = len(train[0]) == sum(DELTA_TRAIN_STEPS) and max(loss_rel) <= HALO_LOSS_RTOL
    checks["ranks_agree_on_losses"] = all(t == train[0] for t in train)
    for r in results:
        for t in r["train"]:
            for k_name, v in t["launches"].items():
                train_launches[k_name] += v
    expect_train = {k_name: n * sum(DELTA_TRAIN_STEPS) * HALO_K for k_name, n in DELTA_LAUNCHES_PER_STEP.items()}
    checks["train_launches"] = {k_name: v for k_name, v in train_launches.items() if v} == expect_train
    fired = [rep["relocalized"] for rep in reps if rep["relocalized"] is not None]
    checks["policy_fired"] = len(fired) >= 1 and all(
        sum(rep["relocalized"] is not None for rep in r["reports"]) == len(fired) for r in results)
    checks["executed_tiles_fall"] = bool(fired) and fired[0]["executed_tiles_after"] < fired[0]["executed_tiles_before"]
    layout = stages["relocalized"]["layout"]
    want = {"x": relocate_node_array(layout, host["features"]).astype(np.float32),
            "labels": relocate_node_array(layout, np.asarray(host["labels"], np.int64)),
            "mask": relocate_node_array(layout, host["train_mask"]).astype(np.float32)}
    checks["moved_blocks_bit_exact"] = all(
        r["moved"] == {k_name: array_checksum(v[rank]) for k_name, v in want.items()}
        for rank, r in enumerate(results))
    del want
    checks["compact"] = all(r["compact"]["version"] == stages["compact"]["version"] for r in results)
    rank_gb = [max(t["host_gb"] for s in r["stages"] for t in s["tables"].values()) for r in results]
    all_k_gb = max(t["host_gb"] for s in results[0]["stages"] for t in s["tables"].values()) * HALO_K
    ok = all(checks.values())
    emit("delta", ok=ok, checks=checks, reduced=HALO_REPS_REDUCED, ranks=HALO_K, group=spec.describe(),
         schedules=["flat", f"{HIER_PODS} pods × 2"],
         stages=per_stage,
         reports_rank0=[{k_name: v for k_name, v in rep.items() if k_name not in ("relocalized", "drift")}
                        for rep in results[0]["reports"]],
         apply_ms_per_rank=[[rep["apply_ms"] for rep in r["reports"]] for r in results],
         burst_tables_per_rank=[r["burst_tables"] for r in results],
         table_maintenance={name: {sch: [(t[sch]["last"], t[sch]["ms"]) for t in rec["tables_per_rank"]]
                                   for sch in rec["tables_per_rank"][0]} for name, rec in per_stage.items()},
         relocalize_ms_per_rank=[[rep["relocalized"]["relocalize_ms"] for rep in r["reports"] if rep["relocalized"]]
                                 for r in results],
         executed_tiles=dict(before=fired[0]["executed_tiles_before"], after=fired[0]["executed_tiles_after"])
         if fired else None,
         drift_readings=script["drift"], policy=DELTA_RELOCALIZE, fired_at_burst_delta=script["fired_at"],
         burst_deltas=len(script["burst"]), compact=results[0]["compact"],
         losses=train[0], losses_unsharded=prep["losses"], loss_max_rel_diff=max(loss_rel),
         step_ms_per_rank=dict(before=[r["step_ms_before"] for r in results],
                               after=[r.get("step_ms_after") for r in results]),
         peak_memory_gb_per_rank=[r.get("peak_memory_gb") for r in results],
         rank_table_host_gb_max_per_rank=rank_gb, all_rank_table_gb_not_held=all_k_gb,
         global_table=dict(patch_ms=prep["global_patch_ms"], widths=prep["global_widths"]),
         launches_all_ranks=launches, train_launches_all_ranks=train_launches,
         script_host_s=prep["script_s"], prepare_s=prep["prepare_s"], seconds=seconds,
         timing=f"CUDA events after a group barrier, median of {HALO_REPS}; host clock for apply, patch and "
                f"rebuild; {HALO_K} ranks share one card")
    require(ok, "delta", f"checks {checks}")
    kernel_errs = {}
    for rec in per_stage.values():
        for case, c in (rec["rank0_kernels"] or {}).items():
            if "max_abs_err" in c:
                kernel_errs[case] = max(kernel_errs.get(case, 0.0), c["max_abs_err"])
    return dict(launches=launches, train_launches=train_launches, kernel_errs=kernel_errs)


def profile_kernels(data: dict, ops: dict) -> dict:
    """`torch_profiler_trace` around one launch of K1 and of each K2 body
    on Nell's shapes: the trace file it writes, and which kernels it names.
    A trace that names no kernel on the card at all is taken again, up to
    PROFILE_TRIES traces in all (CUPTI has once left a trace's kernel
    records out: PERF.md §7); ``attempts`` says how many were taken."""
    import glob
    import os
    import shutil
    import tempfile

    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fused_gcn as fg
    from repro_torch.obs.trace import torch_profiler_trace

    vals, cols, lens = data["vals"], data["cols"], data["lens"]
    for attempt in range(1, PROFILE_TRIES + 1):
        log_dir = tempfile.mkdtemp(prefix="chip_smoke_profile_")
        try:
            torch.cuda.synchronize()
            with torch.inference_mode(), torch_profiler_trace(log_dir):
                z = fg.ff_transform(ops["x"], ops["w1"])
                fg.ff_aggregate(vals, cols, lens, z, ops["b1"], True)
                fg.af_layer(vals, cols, lens, ops["h1"], ops["w2"], ops["b2"], True)
                k1.bsr_spmm(vals, cols, lens, ops["h1"])
                torch.cuda.synchronize()
            files = glob.glob(os.path.join(log_dir, "*.json"))
            names = set()
            for f in files:
                with open(f) as fh:
                    names.update(str(e.get("name", "")) for e in json.load(fh)["traceEvents"] if e.get("cat") == "kernel")
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)
        if names:
            break
    found = {kernel: any(key in name for name in names) for kernel, key in (
        ("k2_ff_transform", "xw_kernel"), ("k2_ff_aggregate", "ragged_layer_kernel<0"),
        ("k2_af_layer", "ragged_layer_kernel<1"), ("k1_bsr_spmm", "ragged_layer_kernel<2"))}
    return dict(files=len(files), device_kernels=len(names), names=found, attempts=attempt)


def run_obs(flat_tracer, hier_tracer, profile: dict) -> None:
    """`overlap_timeline` on the flat 4-rank group and the 2 × 2 groups
    (rank 0's traces), and the `torch_profiler_trace` of `profile_kernels`."""
    flat, hier = overlap_enclosure(flat_tracer), overlap_enclosure(hier_tracer)
    checks = dict(flat_encloses=flat["encloses"] and flat["on_wire_track"],
                  hier_encloses=hier["encloses"] and hier["on_wire_track"],
                  profiler_trace_written=profile["files"] == 1,
                  profiler_names_k1_or_k2=any(profile["names"].values()))
    ok = all(checks.values())
    emit("obs", ok=ok, checks=checks, overlap_flat=flat, overlap_hier=hier, profiler=profile,
         note="overlap spans: host clock, span edges synchronize the card; 4 ranks share it")
    require(ok, "obs", f"checks {checks}")


def run_af_wide(data: dict) -> dict:
    """K2's aggregation-first kernel past one chunk of F_in, on unsharded
    Nell's table at F_out = AF_WIDE_F_OUT: each width of AF_WIDE_F_IN and
    each operand mode against its plain version (fp32 within AF_WIDE_RTOL of
    max, bf16 operands within AF_WIDE_BF16_RTOL), the same bits on two calls,
    the reference's error one column past its bound; ms (the kernel and the
    plain version), bound and what the compiler gave each instantiation at
    its chunk width."""
    from repro_torch.kernels import fused_gcn as fg

    vals, cols, lens = data["vals"], data["cols"], data["lens"]
    device = vals.device
    R, B, f_out = cols.shape[0], 128, AF_WIDE_F_OUT
    nnz = int(lens.sum())
    gen = torch.Generator(device).manual_seed(SEED + 3)
    vals16 = None
    cases, ok = [], True
    for f_in in AF_WIDE_F_IN:
        x = torch.randn((R * B, f_in), generator=gen, device=device)
        w = torch.randn((f_in, f_out), generator=gen, device=device) / f_in ** 0.5
        b = torch.randn((f_out,), generator=gen, device=device)
        ft, chunks = fg.af_chunk(f_in)
        for sfx, (vd, xd, wd) in {"": (torch.float32,) * 3, **BF16_COMBOS}.items():
            if vd == torch.bfloat16 and vals16 is None:
                vals16 = vals.to(torch.bfloat16)
            v = vals16 if vd == torch.bfloat16 else vals
            xs, ws = x.to(xd), w.to(wd)
            with torch.inference_mode():
                out = fg.af_layer(v, cols, lens, xs, ws, b, True)
                again = fg.af_layer(v, cols, lens, xs, ws, b, True)
                ref = fg.af_layer_plain(v, cols, lens, xs, ws, b, True)
                torch.cuda.synchronize()
                err, scale = max_err(out.float(), ref.float())
                rtol = AF_WIDE_RTOL if sfx == "" else AF_WIDE_BF16_RTOL
                case = dict(kernel=f"k2_af_layer{sfx}", f_in=f_in, f_out=f_out, chunk=ft, chunks=chunks,
                            max_abs_err=err, max_abs_plain=scale, rtol=rtol, ok=err <= rtol * scale,
                            same_bits=bool(torch.equal(out, again)), finite=bool(torch.isfinite(out.float()).all()))
                n_bytes = (vd.itemsize * nnz * B * B + xd.itemsize * R * B * (f_in + f_out) + wd.itemsize * f_in * f_out
                           + 4.0 * (R + nnz + f_out))
                case.update(
                    ms=cuda_ms(lambda: fg.af_layer(v, cols, lens, xs, ws, b, True), reps=3, warmup=1),
                    plain_ms=cuda_ms(lambda: fg.af_layer_plain(v, cols, lens, xs, ws, b, True), reps=3, warmup=1),
                    bound=bound(n_bytes, 2.0 * nnz * B * B * f_in + 2.0 * R * B * f_in * f_out,
                                BF16_FLOP_PER_S if sfx == "_bf16_all" else FP32_FLOP_PER_S),
                    compiler=fg.ragged_attributes(f"k2_af_layer{sfx}", ft))
            ok = ok and case["ok"] and case["same_bits"] and case["finite"]
            cases.append(case)
            del out, again, ref, xs, ws
        del x, w, b
    del vals16
    torch.cuda.empty_cache()
    # One column past the reference's bound (resident = 4·(F_in·F_out + 2·128·F_in + 128·F_out + 128²)
    # > 14e6: F_in 9,030 at F_out 128) raises its error, on the card too.
    over = int((fg.AF_RESIDENT_LIMIT / 4 - B * f_out - B * B) // (f_out + 2 * B)) + 1
    try:
        fg.af_layer(vals, cols, lens, torch.zeros((B, over), device=device), torch.zeros((over, f_out), device=device),
                    torch.zeros((f_out,), device=device))
        raised = ""
    except ValueError as exc:
        raised = str(exc)
    refuses = "VMEM-resident" in raised
    emit("af_wide", ok=ok and refuses, cases=cases, refuses_past_the_bound=dict(f_in=over, f_out=f_out, error=raised),
         table=dict(block_rows=R, nnz_tiles=nnz), timing="CUDA events, median of 3 after a warm-up",
         note="a chunk streams the row's tiles again: vals are read once per chunk")
    require(ok and refuses, "af_wide", f"cases {[c for c in cases if not (c['ok'] and c['same_bits'])]}, "
                                       f"raised {raised!r}")
    return {c["kernel"] + f"@{c['f_in']}": c for c in cases}


# ------------------------------------------------------------------- DeepFM
def named_leaves(tree, prefix: str = "") -> dict:
    """{"mlp/l0/w": leaf, "layers/0/attn/l1/b": leaf, ...} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in named_leaves(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in named_leaves(x, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


def check_k3(cfg, shapes, generator: torch.Generator) -> tuple[dict, dict]:
    """(d1): K3 against its plain version on the card at the recsys shapes,
    an odd B and bf16; returns (the worst error per launcher, the timing
    rows: train_batch's as the row, every shape's beside it)."""
    from repro_torch.kernels import fm_interaction as k3

    F, D = cfg.n_fields, cfg.embed_dim
    cases, by_shape = [], {}
    worst = {name: 0.0 for name in k3.LAUNCHES}

    def emb_of(batch, dtype=torch.float32):
        return torch.randn((batch, F, D), generator=generator, device=generator.device).to(dtype)

    with torch.inference_mode():
        for case, batch in [(n, shapes[n].batch) for n in ("serve_p99", "train_batch", "serve_bulk")] + [("odd_B", 1000)]:
            emb = emb_of(batch)
            out, ref = k3.fm_interaction(emb), k3.fm_interaction_plain(emb)
            err, scale = max_err(out, ref)
            ok = err <= KERNEL_RTOL * scale and out.dtype == ref.dtype and tuple(out.shape) == (batch,)
            cases.append(dict(kernel="k3_fm_interaction", case=f"{case} ({batch} × {F} × {D})", max_abs_err=err,
                              max_abs_ref=scale, rtol=KERNEL_RTOL, dtype="float32", ok=ok))
            worst["k3_fm_interaction"] = max(worst["k3_fm_interaction"], err)
            if case != "odd_B":
                by_shape[case] = dict(
                    batch=batch, tile=k3.fm_tile(batch, F, D), ms=device_ms(lambda: k3.fm_interaction(emb)),
                    call_ms=cuda_ms(lambda: k3.fm_interaction(emb)),
                    plain_ms=device_ms(lambda: k3.fm_interaction_plain(emb)), library_ms=None,
                    bound=bound(4.0 * (batch * F * D + batch), 3.0 * batch * F * D + 3.0 * batch * D))
            if case == "train_batch":
                same = bool(torch.equal(out, k3.fm_interaction(emb)))
                cases.append(dict(kernel="k3_fm_interaction", case=f"{case}: two calls, the same bits",
                                  bit_equal_repeat=same, ok=same))
            del emb, out, ref
        batch = shapes["train_batch"].batch
        emb = emb_of(batch, torch.bfloat16)
        out, ref = k3.fm_interaction(emb), k3.fm_interaction_plain(emb)
        err, scale = max_err(out.float(), ref.float())
        bit_equal = float((out == ref).float().mean())
        ok = err <= K1_BF16_STEP * scale and bit_equal >= K1_BF16_BIT_EQUAL and out.dtype == torch.bfloat16
        cases.append(dict(kernel="k3_fm_interaction_bf16", case=f"train_batch bf16 ({batch} × {F} × {D})",
                          max_abs_err=err, max_abs_ref=scale, rtol=K1_BF16_STEP, bit_equal=bit_equal,
                          bit_equal_min=K1_BF16_BIT_EQUAL, dtype="bfloat16", ok=ok))
        worst["k3_fm_interaction_bf16"] = err
        same = bool(torch.equal(out, k3.fm_interaction(emb)))
        cases.append(dict(kernel="k3_fm_interaction_bf16", case="train_batch bf16: two calls, the same bits",
                          bit_equal_repeat=same, ok=same))
        bf16_row = dict(batch=batch, tile=k3.fm_tile(batch, F, D, torch.bfloat16),
                        ms=device_ms(lambda: k3.fm_interaction(emb)), call_ms=cuda_ms(lambda: k3.fm_interaction(emb)),
                        plain_ms=device_ms(lambda: k3.fm_interaction_plain(emb)), library_ms=None,
                        bound=bound(2.0 * (batch * F * D + batch), 3.0 * batch * F * D + 3.0 * batch * D))
        del emb, out, ref
    ok = all(c["ok"] for c in cases)
    compiler = {f"k3_fm_interaction{sfx}": k3.kernel_attributes(dt, shapes["train_batch"].batch, F, D)
                for sfx, dt in (("", torch.float32), ("_bf16", torch.bfloat16))}
    emit("deepfm_kernels", ok=ok, cases=cases,
         times={k: {**v, "bound": list(v["bound"])} for k, v in {**by_shape, "train_batch_bf16": bf16_row}.items()},
         compiler=compiler, spills=sum(c["local_bytes"] for c in compiler.values()),
         timing="ms and plain_ms: device_ms (20 calls queued behind a spin kernel, back to back between two CUDA "
                "events, after 2 warm-ups); call_ms: CUDA-event median of one call, the host's launch included "
                "(serve_p99's 0.8 MB stays in the 50 MB L2; the other shapes do not fit)",
         tile_note="tile: (examples per block, staged in shared memory); compiler: registers, local bytes and "
                   "blocks per SM at train_batch's tile",
         library="none: no single PyTorch call computes the FM term")
    require(ok, "deepfm_kernels", "K3 disagrees with its plain version")
    rows = {"k3_fm_interaction": {**by_shape["train_batch"], "by_shape": by_shape}, "k3_fm_interaction_bf16": bf16_row}
    return worst, rows


def deepfm_ids(cfg, batch: int, seed: int, device: torch.device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.rows_per_field, (batch, cfg.n_fields))).to(device, torch.int64)


def deepfm_serve(params: dict, cfg, shapes) -> dict:
    """(d2): serve_p99 requests and one serve_bulk batch through K3, the
    launch counts zeroed just before and read just after; the logits
    against the same forward with the plain FM term."""
    from repro_torch.kernels import fm_interaction as k3
    from repro_torch.models.deepfm import deepfm_forward
    from repro_torch.recsys.embedding import field_lookup

    device = params["table"].device
    p99, bulk = shapes["serve_p99"].batch, shapes["serve_bulk"].batch
    ids = {"serve_p99": deepfm_ids(cfg, p99, SEED, device), "serve_bulk": deepfm_ids(cfg, bulk, SEED + 1, device)}
    request_ms = []
    with torch.inference_mode():
        torch.cuda.synchronize()
        k3.reset_launch_counts()
        deepfm_forward(params, ids["serve_p99"], cfg)                      # warm-up
        torch.cuda.synchronize()
        for _ in range(DEEPFM_REQUESTS):
            t0 = time.perf_counter()
            logits = {"serve_p99": deepfm_forward(params, ids["serve_p99"], cfg)}
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
        logits["serve_bulk"] = deepfm_forward(params, ids["serve_bulk"], cfg)
        torch.cuda.synchronize()
        launches = dict(k3.LAUNCHES)
        errs, fm_max = {}, {}
        offs = torch.from_numpy(cfg.field_offsets).to(device, torch.int64)
        for name, out in logits.items():
            errs[name] = max_err(out, deepfm_forward(params, ids[name], cfg, fm_term=k3.fm_interaction_plain))
            fm_max[name] = float(k3.fm_interaction_plain(field_lookup(params["table"], ids[name], offs)).abs().max())
        bulk_ms = cuda_ms(lambda: deepfm_forward(params, ids["serve_bulk"], cfg), reps=5)
    expected = {"k3_fm_interaction": 2 + DEEPFM_REQUESTS, "k3_fm_interaction_bf16": 0}
    checks = dict(
        launches=launches == expected,
        shapes=all(tuple(out.shape) == (ids[n].shape[0],) for n, out in logits.items()),
        finite=all(bool(torch.isfinite(out).all()) for out in logits.values()),
        logits_vs_plain_fm=all(err <= DEEPFM_LOGIT_RTOL * scale for err, scale in errs.values()),
    )
    p50 = statistics.median(request_ms)
    emit("deepfm_serve", ok=all(checks.values()), checks=checks, requests=DEEPFM_REQUESTS, batch=p99,
         p50_ms=p50, request_ms=request_ms, examples_per_s=p99 / p50 * 1e3, bulk_batch=bulk, bulk_ms=bulk_ms,
         bulk_examples_per_s=bulk / bulk_ms * 1e3, launches=launches, expected_launches=expected,
         logit_max_abs_err={n: e for n, (e, _) in errs.items()}, max_abs_logit={n: m for n, (_, m) in errs.items()},
         fm_term_max_abs=fm_max, logit_rtol=DEEPFM_LOGIT_RTOL,
         timing=f"p50: host clock, each request ended by a synchronisation; bulk: CUDA events, median of 5")
    require(all(checks.values()), "deepfm_serve", f"checks {checks}")
    return launches


def deepfm_retrieve(params: dict, cfg, shapes) -> None:
    """(d3): one query against field 0's 1,000,000 rows."""
    from repro_torch.models.deepfm import deepfm_retrieval

    spec = shapes["retrieval_cand"]
    device = params["table"].device
    user = deepfm_ids(cfg, spec.batch, SEED + 2, device)
    cand = torch.arange(spec.n_candidates, device=device, dtype=torch.int64)[None, :].expand(spec.batch, -1)
    with torch.inference_mode():
        scores = deepfm_retrieval(params, user, cand, cfg)
        ms = cuda_ms(lambda: deepfm_retrieval(params, user, cand, cfg), reps=5)
    checks = dict(shape=tuple(scores.shape) == (spec.batch, spec.n_candidates),
                  finite=bool(torch.isfinite(scores).all()))
    emit("deepfm_retrieval", ok=all(checks.values()), checks=checks, queries=spec.batch,
         candidates=spec.n_candidates, ms=ms, candidates_per_s=spec.n_candidates * spec.batch / ms * 1e3,
         max_abs_score=float(scores.abs().max()), timing="CUDA events, median of 5")
    require(all(checks.values()), "deepfm_retrieval", f"checks {checks}")


def deepfm_train(params: dict, cfg, shapes) -> dict:
    """(d4): first gradients with K3 against the plain FM term's, then a
    Trainer's AdamW steps at train_batch with the launch counts zeroed just
    before and read just after; step time, peak memory, profile."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import fm_interaction as k3
    from repro_torch.models.deepfm import deepfm_loss, fm_interaction
    from repro_torch.obs.trace import device_time_summary
    from repro_torch.train.data import ShardedStream, click_batch_fn
    from repro_torch.train.loop import Trainer, TrainerConfig, value_and_grad
    from repro_torch.train.optimizer import adamw

    device = params["table"].device
    stream = ShardedStream(click_batch_fn(cfg.n_fields, cfg.rows_per_field),
                           global_batch=shapes["train_batch"].batch, seed=SEED)
    batches = [{"ids": torch.from_numpy(b["ids"]).to(device, torch.int64), "labels": torch.from_numpy(b["labels"]).to(device)}
               for b in (next(stream) for _ in range(DEEPFM_TRAIN_STEPS))]

    def loss_fn(fm_term):
        return lambda p, b: deepfm_loss(p, b["ids"], b["labels"], cfg, fm_term=fm_term)

    loss_k3, g_k3 = value_and_grad(loss_fn(fm_interaction), params, batches[0])
    loss_plain, g_plain = value_and_grad(loss_fn(k3.fm_interaction_plain), params, batches[0])
    grad_err = {n: max_err(g, named_leaves(g_plain)[n]) for n, g in named_leaves(g_k3).items()}
    del g_k3, g_plain
    tr = Trainer(loss_fn(fm_interaction), adamw(DEEPFM_LR), params, TrainerConfig(log_every=DEEPFM_TRAIN_STEPS + 1))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k3.reset_launch_counts()
    t0 = time.perf_counter()
    losses = tr.fit(iter(batches), max_steps=DEEPFM_TRAIN_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(k3.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def one():
        tr.params, tr.opt_state, tr.residual, loss = tr._step_fn(tr.params, tr.opt_state, tr.residual, batches[0])
        float(loss)

    step_ms = wall_ms(one)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            one()
        torch.cuda.synchronize()
    expected = {"k3_fm_interaction": DEEPFM_TRAIN_STEPS, "k3_fm_interaction_bf16": 0}
    checks = dict(
        launches=launches == expected,
        finite_losses=len(losses) == DEEPFM_TRAIN_STEPS and all(np.isfinite(losses)),
        gradients_vs_plain_fm=all(err <= DEEPFM_GRAD_RTOL * scale for err, scale in grad_err.values()),
        zero_gradients=all(grad_err[n][1] == 0.0 for n in grad_err if n.split("/")[0] in ("user_tower", "item_proj")),
    )
    n_params = sum(p.numel() for p in named_leaves(params).values())
    emit("deepfm_train", ok=all(checks.values()), checks=checks, batch=shapes["train_batch"].batch,
         steps=DEEPFM_TRAIN_STEPS, optimizer=f"adamw(lr={DEEPFM_LR})", parameters=n_params, losses=losses,
         first_loss_k3=float(loss_k3), first_loss_plain_fm=float(loss_plain),
         grad_max_abs_err={n: e for n, (e, _) in grad_err.items()}, grad_max_abs={n: m for n, (_, m) in grad_err.items()},
         grad_rtol=DEEPFM_GRAD_RTOL, launches=launches, expected_launches=expected, fit_s=fit_s,
         step_ms=step_ms, peak_memory_train_gb=peak_gb,
         profile=dict(steps=3, **device_time_summary(list(prof.events()), 3)),
         timing="step: host clock, median of 5 after 2 warm-ups, each ended by reading the loss; "
                "peak memory over the five Trainer steps")
    require(all(checks.values()), "deepfm_train", f"checks {checks}")
    return launches


# ------------------------------------------------------------ the GNN families
def gnn_cast(batch: dict, device, dtype=torch.float32) -> dict:
    """A numpy batch on ``device``: floating arrays in ``dtype``, index
    arrays as int64."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, dtype if v.dtype.kind == "f" else torch.int64)
            for k, v in batch.items()}


def gnn_params(arch: str, cfg, device, dtype=torch.float32) -> dict:
    """The model's parameters from ``torch.Generator().manual_seed(SEED)``
    (drawn on the host, so every device and dtype gets the same numbers)."""
    from repro_torch.models import egnn, equiformer_v2, graphcast, pna
    from repro_torch.train.tree import tree_map

    init = {"pna": pna.pna_init, "egnn": egnn.egnn_init, "graphcast": graphcast.graphcast_init,
            "equiformer-v2": equiformer_v2.equiformer_init}[arch]
    params = init(torch.Generator().manual_seed(SEED), cfg, device="cpu")
    return tree_map(lambda v: v.to(device, dtype), params)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out − ref| / max |ref| in float64 (NaN counts as infinite)."""
    err, scale = max_err(out.double().cpu(), ref.double().cpu())
    return err / scale if scale else (0.0 if err == 0 else float("inf"))


def gnn_errors(a: tuple, b: tuple, cancelled: tuple = ()) -> dict:
    """Forward and per-leaf gradient errors of run ``a`` against run ``b``
    (each (output, loss, grads)): the forward's, the loss's and the worst
    leaf's, each relative to the reference's largest entry. A leaf named in
    ``cancelled`` (by suffix: one whose gradient the model cancels, so that
    it is rounding alone) is held against the largest leaf's max instead,
    reported as ``cancelled_leaves``."""
    grads_a, grads_b = named_leaves(a[2]), named_leaves(b[2])
    top = max(float(g.abs().max()) for g in grads_b.values())
    zero = {name for name in grads_b if name.endswith(cancelled)} if cancelled else set()
    leaves = {name: rel_err(grads_a[name], g) for name, g in grads_b.items()
              if float(g.abs().max()) > 0 and name not in zero}
    out = dict(forward=rel_err(a[0], b[0]), loss=abs(a[1] - b[1]) / abs(b[1]),
               grad_worst_leaf=max(leaves.values()), grad_worst_leaf_name=max(leaves, key=leaves.get))
    if zero:
        out["cancelled_leaves"] = max(max_err(grads_a[name].double(), grads_b[name].double())[0] for name in zero) / top
        out["grad_worst_leaf"] = max(out["grad_worst_leaf"], out["cancelled_leaves"])
    return out


def gnn_eval(arch: str, cfg, batch: dict, device, dtype, forward, loss_fn) -> tuple:
    """(output rows, loss, gradient tree) of the model in ``dtype`` on
    ``device``, every tensor moved to the host."""
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.tree import tree_map

    params, b = gnn_params(arch, cfg, device, dtype), gnn_cast(batch, device, dtype)
    with torch.no_grad():
        out = forward(params, b).cpu()
    loss, grads = value_and_grad(loss_fn, params, b)
    return out, float(loss), tree_map(lambda g: g.cpu(), grads)


def build_gnn_data() -> dict:
    """gnn_data's host work (no card): one host graph at Reddit's size
    (minibatch_lg) with positions, a NeighborSampler(fanout (15, 10)) over
    it, and one sampled block of 1,024 seeds, with their checks."""
    from repro_torch.configs.registry import gnn_shapes
    from repro_torch.graph.generators import citation_like
    from repro_torch.graph.sampler import NeighborSampler

    shape = gnn_shapes()[GNN_SHAPE]
    t0 = time.perf_counter()
    g = citation_like(shape.n_nodes, shape.n_edges, shape.d_feat, shape.n_out, seed=SEED, with_positions=True)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = NeighborSampler(g, shape.fanout, seed=SEED)
    sampler_s = time.perf_counter() - t0
    seeds = np.random.default_rng(SEED + 1).choice(g.n_nodes, shape.batch_nodes, replace=False)
    t0 = time.perf_counter()
    blk = sampler.sample(seeds)
    sample_s = time.perf_counter() - t0
    max_nodes, max_edges = sampler.max_shapes(shape.batch_nodes)
    checks = dict(
        graph=g.n_nodes == shape.n_nodes and g.n_edges == shape.n_edges and g.features.shape == (shape.n_nodes, shape.d_feat),
        block_shape=(blk.max_nodes, blk.max_edges) == (max_nodes, max_edges) == GNN_BLOCK_SHAPE,
        seeds_first=bool(np.array_equal(blk.node_ids[:shape.batch_nodes], seeds)),
        edges_inside=bool((blk.senders[:blk.n_edges] < blk.n_nodes).all() and (blk.receivers[:blk.n_edges] < blk.n_nodes).all()),
        no_padding_edges=blk.n_edges == blk.max_edges,
    )
    return dict(graph=g, shape=shape, block=blk, checks=checks,
                host_seconds=dict(generator=gen_s, sampler=sampler_s, sample=sample_s))


def gnn_host_work(device: torch.device) -> dict:
    """The GNN phases' host work, which needs no card time: `build_gnn_data`,
    then side by side gnn_train's host runs of PNA and EGNN
    (`gnn_host_runs`, on GNN_HOST_THREADS threads) and gnn_serve's two
    `GraphBatcher`s (their samplers over the graph's edges are host work;
    only the small parameters go to the card). main() runs it in a thread
    beside the delta phase's group, whose ranks take one thread each."""
    from repro_torch.configs import egnn, pna
    from repro_torch.serve.graph import GraphBatcher

    data = build_gnn_data()
    shape = data["shape"]
    cfgs = {"pna": pna.make_config(shape), "egnn": egnn.make_config(shape)}

    def host_runs():
        torch.set_num_threads(GNN_HOST_THREADS)
        t0 = time.perf_counter()
        runs = {arch: gnn_host_runs(arch, cfg, gnn_block_batch(data, arch, cfg), shape.batch_nodes)
                for arch, cfg in cfgs.items()}
        return runs, time.perf_counter() - t0

    def engines():
        out = {}
        for arch, cfg in cfgs.items():
            t0 = time.perf_counter()
            eng = GraphBatcher(gnn_params(arch, cfg, device), data["graph"], cfg, model=arch, batch_seeds=8,
                               fanout=4, cache_capacity=0, seed=SEED, device=device)
            out[arch] = (eng, time.perf_counter() - t0)
        return out

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs, built = pool.submit(host_runs), pool.submit(engines)
        data["host_runs"], data["host_seconds"]["train_host_runs"] = runs.result()
        data["engines"] = built.result()
    data["host_seconds"]["serve_engines"] = {arch: s for arch, (_, s) in data["engines"].items()}
    return data


def run_gnn_data(built: dict | None = None) -> dict:
    """gnn_data's line: `build_gnn_data`'s result (``built``: `gnn_host_work`'s,
    when main() ran it in a thread beside the delta phase's group, or built
    here)."""
    data = built or build_gnn_data()
    g, blk, shape, checks = data["graph"], data["block"], data["shape"], data["checks"]
    emit("gnn_data", ok=all(checks.values()), checks=checks, shape=dataclasses.asdict(shape),
         n_nodes=g.n_nodes, n_edges=g.n_edges, block=dict(seeds=blk.n_seeds, nodes=blk.n_nodes, edges=blk.n_edges,
                                                         max_nodes=blk.max_nodes, max_edges=blk.max_edges),
         host_seconds=data["host_seconds"], built_beside_delta=built is not None,
         timing="host clock (the card's machine's CPU); built beside the delta phase's group when "
                "built_beside_delta, so those seconds share the host with its ranks; with it, gnn_train's host "
                f"runs (train_host_runs, {GNN_HOST_THREADS} threads) beside gnn_serve's engines (serve_engines)")
    require(all(checks.values()), "gnn_data", f"checks {checks}")
    return dict(graph=g, shape=shape, block=blk, **{k: data.pop(k) for k in ("host_runs", "engines") if k in data})


def gnn_block_batch(data: dict, arch: str, cfg) -> dict:
    """The sampled block as a numpy batch of ``arch``: the block's features
    (zero on padding rows), positions for egnn, a seeded regression target
    on the seed rows, and the edge mask (every edge of this block is real)."""
    g, blk = data["graph"], data["block"]
    valid = blk.node_ids[:blk.n_nodes]
    x = np.zeros((blk.max_nodes, g.features.shape[1]), np.float32)
    x[:blk.n_nodes] = g.features[valid]
    batch = dict(feats=x, senders=blk.senders, receivers=blk.receivers, edge_mask=blk.edge_mask.astype(np.float32),
                 target=(0.1 * np.random.default_rng(SEED + 2).standard_normal((blk.n_seeds, cfg.d_out))).astype(np.float32))
    if arch in ("egnn", "equiformer-v2"):
        pos = np.zeros((blk.max_nodes, 3), np.float32)
        pos[:blk.n_nodes] = g.positions[valid]
        batch["pos"] = pos
    return batch


def gnn_mesh_batch(cfg) -> dict:
    """GraphCast's native processor mesh at R6 (`icosphere_sizes`) as a
    `random_graph`, seeded node variables and positions, the positional
    edge features, and a residual target (the variables plus seeded 0.1-scaled noise)."""
    from repro_torch.graph.generators import random_graph
    from repro_torch.models.graphcast import icosphere_sizes, relative_edge_feats

    n, e = icosphere_sizes(cfg.mesh_refinement)
    g = random_graph(n, e, seed=SEED)
    rng = np.random.default_rng(SEED + 3)
    x = rng.standard_normal((n, cfg.input_dim)).astype(np.float32)
    pos = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    s, r = torch.from_numpy(g.edge_index[0]), torch.from_numpy(g.edge_index[1])
    feats = relative_edge_feats(pos, pos, s, r).numpy()
    target = (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    return dict(feats=x, edge_feats=feats, senders=g.edge_index[0], receivers=g.edge_index[1], target=target)


def gnn_hold_fns(arch: str, cfg, n_loss: int | None) -> tuple:
    """(the training loss `_gnn_loss_fn`, the forward, the hold's loss) of
    ``arch``: GraphCast's hold runs float64 with the per-layer recompute
    (remat, the same arithmetic: float64 at R6 needs it)."""
    from repro_torch.launch.steps import _gnn_loss_fn
    from repro_torch.models.graphcast import graphcast_forward

    loss_fn = _gnn_loss_fn(arch, cfg, n_loss_nodes=n_loss)
    if arch == "graphcast":
        def forward(p, b, remat=False):
            return graphcast_forward(p, b["feats"], b["edge_feats"], b["senders"], b["receivers"], cfg, remat=remat)

        def hold_loss(p, b):
            return (forward(p, b, remat=b["feats"].dtype == torch.float64) - b["target"]).square().mean()
        return loss_fn, forward, hold_loss
    from repro_torch.launch.gnn_halo import gnn_forward

    def forward(p, b):
        return gnn_forward(arch, p, cfg, b["feats"], b.get("pos"), b["senders"], b["receivers"],
                           edge_mask=b.get("edge_mask"))

    return loss_fn, forward, loss_fn


def gnn_host_runs(arch: str, cfg, batch: dict, n_loss: int | None) -> dict:
    """The host's half of gnn_train's hold of ``arch`` (PNA, EGNN): the
    model in float64 and in fp32 on the host (`gnn_eval`)."""
    _, forward, hold_loss = gnn_hold_fns(arch, cfg, n_loss)
    cpu = torch.device("cpu")
    return {"host_fp64": gnn_eval(arch, cfg, batch, cpu, torch.float64, forward, hold_loss),
            "host_fp32": gnn_eval(arch, cfg, batch, cpu, torch.float32, forward, hold_loss)}


def gnn_train_model(arch: str, cfg, batch: dict, device: torch.device, n_loss: int | None, host_hold: bool,
                    host_batch: dict | None = None, cancelled: tuple = (), host_runs: dict | None = None) -> dict:
    """One model: the hold (fp32 on the card against float64 on the card;
    for PNA and EGNN also float64 on the card against float64 on the host,
    and the host's fp32 error beside, from ``host_runs`` where main() made
    them already (`gnn_host_runs`); with ``host_batch``, a slice of the
    batch, all of that on the slice only, the first loss held too), then
    GNN_TRAIN_STEPS AdamW steps of a Trainer through `_gnn_loss_fn`, the
    step split, peak memory, the profile of one step. ``cancelled``:
    `gnn_errors`'s leaves whose gradient the model cancels."""
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import adamw

    t0 = time.perf_counter()
    loss_fn, forward, hold_loss = gnn_hold_fns(arch, cfg, n_loss)
    if host_batch is not None:
        # The whole hold on the slice, where the host's runs are affordable.
        cpu = torch.device("cpu")
        sl = {name: gnn_eval(arch, cfg, host_batch, dev, dtype, forward, hold_loss)
              for name, dev, dtype in (("card_fp32", device, torch.float32), ("card_fp64", device, torch.float64),
                                       ("host_fp64", cpu, torch.float64), ("host_fp32", cpu, torch.float32))}
        hold = {"slice_card_fp32_vs_card_fp64": gnn_errors(sl["card_fp32"], sl["card_fp64"], cancelled),
                "slice_card_fp64_vs_host_fp64": gnn_errors(sl["card_fp64"], sl["host_fp64"], cancelled),
                "slice_host_fp32_vs_card_fp64": gnn_errors(sl["host_fp32"], sl["card_fp64"], cancelled)}
        del sl
        card, f64 = hold["slice_card_fp32_vs_card_fp64"], hold["slice_card_fp64_vs_host_fp64"]
        intrinsic = hold["slice_host_fp32_vs_card_fp64"]
        gate = {k: max(GNN_HOLD_RTOL, GNN_HOLD_FACTOR * intrinsic[k]) for k in ("forward", "grad_worst_leaf", "loss")}
        hold_ok = dict(fp64_card_vs_host=max(f64["forward"], f64["grad_worst_leaf"], f64["loss"]) <= GNN_F64_RTOL,
                       loss=card["loss"] <= gate["loss"])
    else:
        runs = {"card_fp32": gnn_eval(arch, cfg, batch, device, torch.float32, forward, hold_loss)}
        gc.collect()
        torch.cuda.empty_cache()
        runs["card_fp64"] = gnn_eval(arch, cfg, batch, device, torch.float64, forward, hold_loss)
        gc.collect()
        torch.cuda.empty_cache()
        hold = {"card_fp32_vs_card_fp64": gnn_errors(runs["card_fp32"], runs["card_fp64"], cancelled)}
        card = hold["card_fp32_vs_card_fp64"]
        if host_hold:
            runs.update(host_runs or gnn_host_runs(arch, cfg, batch, n_loss))
            hold["card_fp64_vs_host_fp64"] = gnn_errors(runs["card_fp64"], runs["host_fp64"])
            hold["host_fp32_vs_card_fp64"] = gnn_errors(runs["host_fp32"], runs["card_fp64"])
            intrinsic = hold["host_fp32_vs_card_fp64"]
            gate = {k: max(GNN_HOLD_RTOL, GNN_HOLD_FACTOR * intrinsic[k]) for k in ("forward", "grad_worst_leaf")}
            f64 = hold["card_fp64_vs_host_fp64"]
            hold_ok = dict(fp64_card_vs_host=max(f64["forward"], f64["grad_worst_leaf"]) <= GNN_F64_RTOL)
        else:
            gate = {k: GNN_HOLD_RTOL for k in ("forward", "grad_worst_leaf")}
            hold_ok = {}
        del runs
    hold_ok.update(forward=card["forward"] <= gate["forward"], gradient=card["grad_worst_leaf"] <= gate["grad_worst_leaf"])
    gc.collect()
    torch.cuda.empty_cache()
    hold_s = time.perf_counter() - t0

    params = gnn_params(arch, cfg, device)
    b = gnn_cast(batch, device)
    tr = Trainer(loss_fn, adamw(GNN_LR), params, TrainerConfig(log_every=10**9))
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = timed_fit(tr, b, GNN_TRAIN_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    split = train_split(tr, loss_fn, b)[0]
    prof = profile_fit(tr, b, 1)
    del tr, b
    gc.collect()
    torch.cuda.empty_cache()
    checks = dict(**{f"hold_{k}": v for k, v in hold_ok.items()}, finite_losses=bool(np.isfinite(losses).all()),
                  loss_falls=losses[-1] < losses[0])
    return dict(ok=all(checks.values()), checks=checks, config=dataclasses.asdict(cfg), hold=hold, hold_gate=gate,
                losses=losses, step_ms=step_ms, step_ms_median=statistics.median(step_ms), split=split,
                peak_memory_gb=peak_gb, profile=prof, seconds=time.perf_counter() - t0, hold_seconds=hold_s)


def run_gnn_train(data: dict, device: torch.device) -> None:
    """gnn_train, one line a model: pna and egnn at make_config(minibatch_lg)
    on the sampled block, the loss over the seed rows; graphcast at
    make_config(None), depth cut to GNN_GRAPHCAST_LAYERS, on its R6 mesh.
    Each: the hold, then GNN_TRAIN_STEPS AdamW steps."""
    from repro_torch.configs import egnn, graphcast, pna

    shape, host_runs = data["shape"], data.pop("host_runs", {})
    full = graphcast.make_config(None)
    runs = [(arch, mod.make_config(shape), lambda cfg, arch=arch: gnn_block_batch(data, arch, cfg), shape.batch_nodes)
            for arch, mod in (("pna", pna), ("egnn", egnn))]
    runs.append(("graphcast", dataclasses.replace(full, n_layers=GNN_GRAPHCAST_LAYERS), gnn_mesh_batch, None))
    for arch, cfg, make_batch, n_loss in runs:
        line = gnn_train_model(arch, cfg, make_batch(cfg), device, n_loss, host_hold=arch != "graphcast",
                               host_runs=host_runs.pop(arch, None))
        reduced = {}
        if arch == "graphcast":
            flop = gnn_forward_flops(cfg)
            line.update(forward_tflop=flop / 1e12, forward_bound_ms=flop / FP32_FLOP_PER_S * 1e3,
                        step_tflop_per_s=3 * flop / (line["step_ms_median"] / 1e3) / 1e12)
            if cfg.n_layers != full.n_layers:
                reduced = {"n_layers": f"{full.n_layers} → {cfg.n_layers} (16 layers' fp32 activations at R6 "
                                       "passed the card's 80 GB)"}
        emit("gnn_train", model=arch, reduced=reduced, steps=GNN_TRAIN_STEPS, lr=GNN_LR, **line,
             hold_rule=f"fp32 vs float64 on the card within max({GNN_HOLD_RTOL}, {GNN_HOLD_FACTOR} × the host's "
                       "fp32 error against the same float64) of max |·| (forward; gradient: the worst leaf, each "
                       f"against its own max), and float64 card vs host within {GNN_F64_RTOL}; graphcast: "
                       f"{GNN_HOLD_RTOL} flat, its float64 gradient with remat (the same arithmetic)",
             timing="host clock around each Trainer step (ends in the loss's read-back); the split: one more "
                    "step's forward, backward and update, each ended by a synchronisation; idle share: "
                    "torch.profiler over one step")
        require(line["ok"], "gnn_train", f"{arch}: checks {line['checks']}")
        gc.collect()
        torch.cuda.empty_cache()


def gnn_forward_flops(cfg) -> float:
    """GraphCast's useful forward FLOPs on its icosphere mesh (2 × the
    defining matmuls' MACs): the reference's ``_gnn_flops``
    (src/repro/launch/steps.py)."""
    from repro_torch.models.graphcast import icosphere_sizes

    n_nodes, n_edges = icosphere_sizes(cfg.mesh_refinement)
    d = cfg.d_hidden
    return 2.0 * cfg.n_layers * (n_edges * 4 * d * d + n_nodes * 3 * d * d)


def equiformer_batch(shape) -> dict:
    """equiformer_train's numpy batch at a registry shape: ``molecule_batch``
    (128 × 30 atoms, 64 edges each) or Cora's size as a `citation_like`
    graph with positions; a seeded 0.1-scaled regression target on every
    node."""
    from repro_torch.graph.generators import citation_like, molecule_batch

    if shape.n_graphs is not None:
        g = molecule_batch(shape.n_graphs, shape.n_nodes, shape.n_edges, shape.d_feat, seed=SEED)
    else:
        g = citation_like(shape.n_nodes, shape.n_edges, shape.d_feat, shape.n_out, seed=SEED, with_positions=True)
    target = 0.1 * np.random.default_rng(SEED + 4).standard_normal((g.n_nodes, shape.n_out))
    return dict(feats=g.features.astype(np.float32), pos=g.positions, senders=g.edge_index[0],
                receivers=g.edge_index[1], target=target.astype(np.float32))


def equiformer_slice(batch: dict, n: int) -> dict:
    """The subgraph on nodes ``< n`` (the edges among them, in order)."""
    keep = (batch["senders"] < n) & (batch["receivers"] < n)
    return dict(feats=batch["feats"][:n], pos=batch["pos"][:n], senders=batch["senders"][keep],
                receivers=batch["receivers"][keep], target=batch["target"][:n])


def equiformer_forward_flops(cfg, n_nodes: int, n_edges: int) -> float:
    """The reference's ``_gnn_flops`` (2 × the defining matmuls' MACs) of one
    forward on a graph of this size."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch.steps import _gnn_flops

    return _gnn_flops("equiformer-v2", ShapeSpec("g", "graph", n_nodes=n_nodes, n_edges=n_edges), cfg)


def run_equiformer(data: dict, device: torch.device) -> None:
    """The EquiformerV2 phases at full width (12 layers, C 128, l_max 6,
    m_max 2, 8 heads): equiformer_train (the hold and GNN_TRAIN_STEPS AdamW
    steps at molecule and full_graph_sm), equiformer_equivariance,
    equiformer_chunk and equiformer_block (the forward at gnn_data's
    sampled block, chunked by the cell's big-edge rule)."""
    from repro_torch.configs import equiformer_v2 as eq_cfg
    from repro_torch.configs.registry import gnn_shapes
    from repro_torch.launch.gnn_halo import gnn_forward

    shapes = gnn_shapes()
    batches = {}
    for name in EQ_SHAPES:
        cfg = eq_cfg.make_config(shapes[name])
        batch = batches[name] = equiformer_batch(shapes[name])
        line = gnn_train_model("equiformer-v2", cfg, batch, device, None, host_hold=False,
                               host_batch=equiformer_slice(batch, EQ_HOST_NODES[name]), cancelled=EQ_CANCELLED)
        flop = equiformer_forward_flops(cfg, batch["feats"].shape[0], batch["senders"].shape[0])
        line.update(nodes=batch["feats"].shape[0], edges=batch["senders"].shape[0], forward_tflop=flop / 1e12,
                    forward_bound_ms=flop / FP32_FLOP_PER_S * 1e3,
                    step_tflop_per_s=3 * flop / (line["step_ms_median"] / 1e3) / 1e12)
        emit("equiformer_train", model="equiformer-v2", shape=name, reduced={}, steps=GNN_TRAIN_STEPS, lr=GNN_LR,
             **line, host_slice_nodes=EQ_HOST_NODES[name],
             hold_rule=f"on the slice of nodes < host_slice_nodes: fp32 vs float64 on the card, forward, first loss "
                       f"and every gradient leaf within max({GNN_HOLD_RTOL}, {GNN_HOLD_FACTOR} × the host's fp32 "
                       f"error against the same float64) of max |·| (each leaf against its own max; {EQ_CANCELLED}, "
                       f"whose gradient the softmax cancels, against the largest leaf's), and float64 card vs host "
                       f"within {GNN_F64_RTOL}",
             timing="host clock around each Trainer step (ends in the loss's read-back); the split: one more "
                    "step's forward, backward and update, each ended by a synchronisation; idle share: "
                    "torch.profiler over one step; forward_bound_ms: the reference's _gnn_flops at 67 TFLOP/s fp32")
        require(line["ok"], "equiformer_train", f"{name}: checks {line['checks']}")
        gc.collect()
        torch.cuda.empty_cache()

    # equiformer_equivariance: a seeded rotation and translation of the positions
    r = np.random.default_rng(SEED + 5)
    q = np.linalg.qr(r.standard_normal((3, 3)))[0]
    q[:, 0] *= np.sign(np.linalg.det(q))
    rot, shift = torch.from_numpy(q.astype(np.float32)).to(device), torch.tensor([1.0, -2.0, 3.0], device=device)
    params = gnn_params("equiformer-v2", eq_cfg.make_config(shapes["molecule"]), device)
    errs = {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        for name in EQ_SHAPES:
            cfg = eq_cfg.make_config(shapes[name])
            p = params if name == "molecule" else gnn_params("equiformer-v2", cfg, device)
            b = gnn_cast(batches[name], device)
            out = gnn_forward("equiformer-v2", p, cfg, b["feats"], b["pos"], b["senders"], b["receivers"])
            moved = gnn_forward("equiformer-v2", p, cfg, b["feats"], b["pos"] @ rot.T + shift, b["senders"],
                                b["receivers"])
            errs[name] = dict(rel_err=rel_err(moved, out), finite=bool(torch.isfinite(out).all()),
                              shape=list(out.shape))
    checks = {f"{name}_invariant": e["rel_err"] <= EQ_EQUIVARIANCE_RTOL and e["finite"] for name, e in errs.items()}
    emit("equiformer_equivariance", ok=all(checks.values()), checks=checks, errors=errs, gate=EQ_EQUIVARIANCE_RTOL,
         rotation_det=float(np.linalg.det(q)), translation=[1.0, -2.0, 3.0], seconds=time.perf_counter() - t0,
         note="max |f(R·pos + t) − f(pos)| / max |f(pos)|, fp32 on the card, inference mode")
    require(all(checks.values()), "equiformer_equivariance", f"errors {errs}")

    # equiformer_chunk: edge_chunk EQ_CHUNK against the unchunked messages
    cfg = eq_cfg.make_config(shapes["molecule"])
    b = gnn_cast(batches["molecule"], device)
    fwd = lambda c: gnn_forward("equiformer-v2", params, c, b["feats"], b["pos"], b["senders"], b["receivers"])
    chunked = dataclasses.replace(cfg, edge_chunk=EQ_CHUNK)
    with torch.inference_mode():
        whole, parts = fwd(cfg), fwd(chunked)
        err = rel_err(parts, whole)
        ms = dict(unchunked=cuda_ms(lambda: fwd(cfg), reps=2, warmup=0),
                  chunked=cuda_ms(lambda: fwd(chunked), reps=2, warmup=0))
    ok = err <= EQ_CHUNK_RTOL and bool(torch.isfinite(parts).all())
    emit("equiformer_chunk", ok=ok, rel_err=err, gate=EQ_CHUNK_RTOL, edge_chunk=EQ_CHUNK,
         edges=int(b["senders"].shape[0]), chunks=-(-int(b["senders"].shape[0]) // EQ_CHUNK), forward_ms=ms,
         timing="CUDA-event medians of 2 forwards after the held ones")
    require(ok, "equiformer_chunk", f"chunked vs unchunked {err}")
    del params, b, whole, parts
    gc.collect()
    torch.cuda.empty_cache()
    run_equiformer_block(data, device)


def run_equiformer_block(data: dict, device: torch.device) -> None:
    """equiformer_block: the forward at gnn_data's sampled block of a
    Reddit-sized graph (make_config(minibatch_lg), edge_chunk by the cell's
    big-edge rule) in fp32 against float64 on the card, ms, peak memory and
    idle share. Forward only: training keeps ≈ 1 MB an edge, 160 GB here."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.gnn_halo import gnn_forward
    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.steps import build_cell
    from repro_torch.obs.trace import device_time_summary

    spec, shape = get_arch("equiformer-v2"), data["shape"]
    t0 = time.perf_counter()
    cfg = build_cell(spec, shape, Grid(("data", "model"), (1, 1))).cfg
    batch = gnn_block_batch(data, "equiformer-v2", cfg)
    n_nodes, n_edges = batch["feats"].shape[0], batch["senders"].shape[0]

    def forward(p, b, c=cfg):
        return gnn_forward("equiformer-v2", p, c, b["feats"], b["pos"], b["senders"], b["receivers"],
                           edge_mask=b["edge_mask"])

    with torch.inference_mode():
        out = {}
        for dtype in (torch.float64, torch.float32):
            p, b = gnn_params("equiformer-v2", cfg, device, dtype), gnn_cast(batch, device, dtype)
            c = cfg if dtype == torch.float32 else dataclasses.replace(cfg, edge_chunk=EQ_BLOCK_FP64_CHUNK)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out[dtype] = forward(p, b, c)[: shape.batch_nodes].cpu()
            peak = torch.cuda.max_memory_allocated() / 1e9
            if dtype == torch.float32:
                ms = cuda_ms(lambda: forward(p, b), reps=EQ_BLOCK_REPS, warmup=0)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    forward(p, b)
                    torch.cuda.synchronize()
                prof_summary = device_time_summary(list(prof.events()), 1)
            else:
                peak64 = peak
            del p, b
            gc.collect()
            torch.cuda.empty_cache()
    err = rel_err(out[torch.float32], out[torch.float64])
    flop = equiformer_forward_flops(cfg, n_nodes, n_edges)
    checks = dict(finite=bool(torch.isfinite(out[torch.float32]).all()),
                  shape=list(out[torch.float32].shape) == [shape.batch_nodes, cfg.d_out],
                  block_shape=(n_nodes, n_edges) == GNN_BLOCK_SHAPE, fp32_vs_fp64=err <= GNN_HOLD_RTOL,
                  one_chunk=cfg.edge_chunk == -(-shape.n_edges // 64) and cfg.edge_chunk >= n_edges)
    emit("equiformer_block", ok=all(checks.values()), checks=checks, config=dataclasses.asdict(cfg), reduced={},
         nodes=n_nodes, edges=n_edges, forward_ms=ms, peak_memory_gb=peak, peak_memory_gb_fp64=peak64,
         seed_rows_fp32_vs_fp64=err, gate=GNN_HOLD_RTOL, forward_tflop=flop / 1e12,
         forward_bound_ms=flop / FP32_FLOP_PER_S * 1e3, tflop_per_s=flop / (ms / 1e3) / 1e12, profile=prof_summary,
         seconds=time.perf_counter() - t0,
         note="edge_chunk = ceil(minibatch_lg's 114,615,892 edges / 64) (steps.py's big-edge rule, the reference's) "
              "≥ the block's edges: one chunk; forward only (training holds ≈ 1 MB an edge); rows held: the seeds', "
              f"against float64 in chunks of {EQ_BLOCK_FP64_CHUNK} edges",
         timing=f"CUDA-event median of {EQ_BLOCK_REPS} forwards after the held one; idle share: torch.profiler "
                "over one forward")
    require(all(checks.values()), "equiformer_block", f"checks {checks}")


def run_gnn_serve(data: dict, device: torch.device) -> None:
    """gnn_serve: pna and egnn at make_config(minibatch_lg) through
    GraphBatcher on the gnn_data graph with the serve CLI's defaults
    (batch_seeds 8, fanout 4, cache off), GNN_SERVE_QUERIES hot_query_stream
    queries each; every micro-batch's served rows against the same packed
    micro-batch through the engine's forward on the host (float64, and the
    host's fp32 beside for the gate); the profiler's idle share over 32
    more queries."""
    import types

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import egnn, pna
    from repro_torch.obs.trace import device_time_summary
    from repro_torch.serve.graph import GraphBatcher, hot_query_stream
    from repro_torch.train.tree import tree_map

    g, shape, lines = data["graph"], data["shape"], {}
    engines = data.pop("engines", {})          # built beside the delta phase's group (`gnn_host_work`)
    beside = set(engines)
    for arch, mod in (("pna", pna), ("egnn", egnn)):
        t0 = time.perf_counter()
        cfg = mod.make_config(shape)
        eng, build_s = engines.pop(arch, (None, None))
        if eng is None:
            eng = GraphBatcher(gnn_params(arch, cfg, device), g, cfg, model=arch, batch_seeds=8, fanout=4,
                               cache_capacity=0, seed=SEED, device=device)
            build_s = time.perf_counter() - t0
        width = shape.d_feat + (3 if arch == "egnn" else 0)
        ghost = torch.full((eng.max_edges,), eng.max_nodes, dtype=torch.int32, device=device)
        with torch.inference_mode():          # warm-up at the engine's one shape, outside the stream
            eng._forward(torch.zeros((eng.max_nodes, width), device=device), ghost, ghost,
                         torch.zeros(eng.max_edges, device=device), (), ())
        calls, fwd = [], eng._forward

        def recording(x, s, r, w, masks, vals, fwd=fwd, calls=calls):
            out = fwd(x, s, r, w, masks, vals)
            calls.append((x, s, r, w, out[0]))
            return out

        eng._forward = recording
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for v in hot_query_stream(g, GNN_SERVE_QUERIES, seed=SEED + 1):
            eng.submit(int(v))
        eng.run_until_drained()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        stats = eng.stats()
        eng._forward = fwd
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for v in hot_query_stream(g, 32, seed=SEED + 2):
                eng.submit(int(v))
            eng.run_until_drained()
            torch.cuda.synchronize()
        idle = device_time_summary(list(prof.events()), 32 // 8)
        # The hold: each micro-batch's served rows (its distinct seeds lead the block).
        seeds_of = {}
        for q in eng.finished[:GNN_SERVE_QUERIES]:
            seeds_of.setdefault(q.micro_batch, set()).add(q.node)
        host = {dt: types.SimpleNamespace(model=arch, cfg=cfg, policy=eng.policy, max_nodes=eng.max_nodes,
                                          params=gnn_params(arch, cfg, "cpu", dt), _signatures=set(), traces=0)
                for dt in (torch.float32, torch.float64)}
        worst = dict(card=0.0, host_fp32=0.0)
        for i, (x, s, r, w, out) in enumerate(calls):
            k = len(seeds_of[i])
            args = [t.cpu() for t in (x, s, r, w)]
            with torch.inference_mode():
                ref64 = GraphBatcher._forward(host[torch.float64], args[0].double(), args[1], args[2],
                                              args[3].double(), (), ())[0][:k]
                host32 = GraphBatcher._forward(host[torch.float32], *args, (), ())[0][:k]
            worst["card"] = max(worst["card"], rel_err(out[:k], ref64))
            worst["host_fp32"] = max(worst["host_fp32"], rel_err(host32, ref64))
        gate = max(GNN_HOLD_RTOL, GNN_HOLD_FACTOR * worst["host_fp32"])
        checks = dict(served=stats["queries"] == GNN_SERVE_QUERIES, one_shape=stats["traces"] == 1,
                      hold=worst["card"] <= gate,
                      finite=all(np.isfinite(q.logits).all() for q in eng.finished))
        lines[arch] = dict(ok=all(checks.values()), checks=checks, config=dataclasses.asdict(cfg),
                           hold=dict(worst_rel_err_card_vs_host_fp64=worst["card"],
                                     worst_rel_err_host_fp32_vs_host_fp64=worst["host_fp32"], gate=gate),
                           p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"], queries_per_s=stats["queries"] / seconds,
                           micro_batches=stats["micro_batches"], ms_per_micro_batch=seconds / stats["micro_batches"] * 1e3,
                           nodes_per_query=stats["nodes_per_query"],
                           edges_per_query=stats["edges_per_query"], block=dict(max_nodes=eng.max_nodes,
                                                                                max_edges=eng.max_edges),
                           engine_build_s=build_s, engine_built_beside_delta=arch in beside, idle=idle)
        del eng, calls, host
        gc.collect()
        torch.cuda.empty_cache()
    ok = all(line["ok"] for line in lines.values())
    emit("gnn_serve", ok=ok, models=lines, queries=GNN_SERVE_QUERIES, batch_seeds=8, fanout=4, cache="off",
         hold_rule=f"each micro-batch's served rows within max({GNN_HOLD_RTOL}, {GNN_HOLD_FACTOR} × the host's fp32 "
                   "error) of max |host float64 rows|, the worst over the stream",
         timing="latency: host clock from submit to the served rows on the host; idle share: torch.profiler over "
                "32 more queries (4 micro-batches)")
    require(ok, "gnn_serve", json.dumps({k: v["checks"] for k, v in lines.items()}))


def run_gnn_halo(host: dict, halo: dict, device: torch.device) -> list:
    """gnn_halo: pna, egnn and graphcast at full width over the halo phase's
    Nell plan (d_in 5,414, positions seeded per node), each with the fp32
    and the bf16 wire, on HALO_K ranks sharing the card (gloo), against the
    unsharded forward on the card. Returns each rank's K1–K4 launches."""
    from repro_torch.configs import egnn, graphcast, pna
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.dist.halo import restore_node_array
    from repro_torch.launch.gnn_halo import gnn_forward, gnn_halo_jobs, gnn_halo_rank
    from repro_torch.launch.mesh import GroupSpec, run_group
    from repro_torch.train.tree import tree_map

    t0 = time.perf_counter()
    from repro_torch.graph.generators import TABLE_I

    plan, spec = halo["plan"], TABLE_I[DATASET]
    shape = ShapeSpec(spec.name, "graph", n_nodes=spec.n_nodes, n_edges=spec.n_edges, d_feat=spec.n_features,
                      n_out=spec.n_labels)
    models = [(arch, mod.make_config(shape)) for arch, mod in (("pna", pna), ("egnn", egnn), ("graphcast", graphcast))]
    models[2] = ("graphcast", dataclasses.replace(models[2][1], n_layers=GNN_HALO_GRAPHCAST_LAYERS))
    pos = np.random.default_rng(SEED + 7).standard_normal((plan.n_nodes, 3)).astype(np.float32)
    s = torch.from_numpy(host["edge_index"][0]).to(device)
    r = torch.from_numpy(host["edge_index"][1]).to(device)
    x = torch.from_numpy(host["features"]).to(device, torch.float32)
    p = torch.from_numpy(pos).to(device)
    refs, unsharded_ms, params_np = {}, {}, {}
    with torch.inference_mode():
        for arch, cfg in models:
            params = gnn_params(arch, cfg, device)
            params_np[arch] = tree_map(lambda v: v.cpu().numpy(), params)
            refs[arch] = gnn_forward(arch, params, cfg, x, p, s, r).cpu().numpy()
            unsharded_ms[arch] = cuda_ms(lambda: gnn_forward(arch, params, cfg, x, p, s, r), reps=3, warmup=1)
            del params
    del x, p, s, r
    gc.collect()
    torch.cuda.empty_cache()
    jobs = gnn_halo_jobs(plan, host["features"], pos, [(a, c, params_np[a]) for a, c in models],
                         payloads=(None, "bf16"), time_reps=GNN_HALO_REPS)
    spec_g = GroupSpec(k=HALO_K, backend="gloo", devices=("cuda:0",), timeout_s=HALO_TIMEOUT_S)
    results = run_group(spec_g, gnn_halo_rank, jobs)
    lines, checks = {}, {}
    for arch, cfg in models:
        ref = refs[arch]
        scale = float(np.abs(ref).max())
        for payload in ("fp32", "bf16"):
            key = f"{arch}/{payload}"
            recs = [res[key] for res in results]
            out = restore_node_array(plan, np.stack([rec["rows"] for rec in recs]))
            err = float(np.abs(out - ref).max())
            rel_l2 = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
            if payload == "fp32":
                ok = err <= GNN_HALO_FP32_RTOL * scale
                gate = dict(max_abs_rel=GNN_HALO_FP32_RTOL)
            elif arch == "pna":
                ok = err < GNN_HALO_BF16_ABS and rel_l2 < GNN_HALO_BF16_REL_L2
                gate = dict(max_abs=GNN_HALO_BF16_ABS, rel_l2=GNN_HALO_BF16_REL_L2)
            else:
                ok = err <= GNN_HALO_BF16_RTOL * scale and rel_l2 <= GNN_HALO_BF16_REL_L2
                gate = dict(max_abs_rel=GNN_HALO_BF16_RTOL, rel_l2=GNN_HALO_BF16_REL_L2)
            checks[key] = ok and all(rec["finite"] for rec in recs) and all(
                rec["exchanges"] == cfg.n_layers + (arch == "graphcast") for rec in recs)
            lines[key] = dict(max_abs_err=err, max_abs_unsharded=scale, rel_l2=rel_l2, gate=gate,
                              exchange_width=recs[0]["exchange_width"],
                              wire_bytes_per_layer_per_rank=[rec["wire_bytes_per_layer"] for rec in recs],
                              wire_bytes_forward_per_rank=[rec["wire_bytes"] for rec in recs],
                              exchange_ms_per_rank=[rec["exchange_ms"] for rec in recs],
                              forward_ms_per_rank=[rec["forward_ms"] for rec in recs])
        lines[f"{arch}/unsharded_ms"] = unsharded_ms[arch]
    ok = all(checks.values())
    reduced = {"graphcast n_layers": f"16 → {GNN_HALO_GRAPHCAST_LAYERS} (the script's time limit; an exchange of "
                                     "76.5 MB a layer through gloo); widths whole",
               "timed repetitions": f"3 → {GNN_HALO_REPS} (the script's time limit)"}
    emit("gnn_halo", ok=ok, checks=checks, reduced=reduced, ranks=HALO_K, group=spec_g.describe(), plan=dict(
             k=plan.k, n_local=plan.n_local, s_max=plan.s_max, e_local=plan.e_local,
             halo_rows_per_rank_per_exchange=plan.halo_rows_per_device),
         configs={a: dataclasses.asdict(c) for a, c in models}, variants=lines, seconds=time.perf_counter() - t0,
         timing=f"CUDA events after a group barrier, median of {GNN_HALO_REPS}; {HALO_K} ranks share one card "
                "(gloo through the host), so these are not multi-card times; unsharded: the parent alone")
    require(ok, "gnn_halo", f"checks {checks}")
    return [res["launches"] for res in results]


def run_gnn(host: dict, halo: dict, device: torch.device, built: dict | None = None) -> None:
    """The GNN families' phases, K1–K4's launch counts zeroed just before
    and read just after (line ``gnn_launches``: none may launch);
    ``built``: `build_gnn_data`'s result, if main() made it already."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    data = run_gnn_data(built)
    run_gnn_train(data, device)
    run_gnn_serve(data, device)
    gc.collect()
    torch.cuda.empty_cache()
    run_equiformer(data, device)
    del data, built
    gc.collect()
    torch.cuda.empty_cache()
    ranks = run_gnn_halo(host, halo, device)
    parent = launch_counts()
    ok = not any(parent.values()) and not any(n for r in ranks for n in r.values())
    emit("gnn_launches", ok=ok, parent=parent, ranks=ranks,
         note="K1–K4 counted from zero before gnn_data, read after gnn_halo (the ranks: each its own): "
              "the GNN paths launch no hand-written kernel")
    require(ok, "gnn_launches", f"parent {parent}, ranks {ranks}")


def run_deepfm(device: torch.device) -> tuple[dict, dict, dict]:
    """(d1)–(d4) at the full DeepFM config; returns (K3's launches in the
    serving run, in the training run, the timing rows and worst errors)."""
    from repro_torch.configs.deepfm import FULL
    from repro_torch.configs.registry import recsys_shapes
    from repro_torch.models.deepfm import deepfm_init

    t0 = time.perf_counter()
    shapes = recsys_shapes()
    worst, rows = check_k3(FULL, shapes, torch.Generator(device=device).manual_seed(SEED))
    t1 = time.perf_counter()
    params = deepfm_init(torch.Generator(device=device).manual_seed(SEED), FULL, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    serve = deepfm_serve(params, FULL, shapes)
    deepfm_retrieve(params, FULL, shapes)
    train = deepfm_train(params, FULL, shapes)
    emit("deepfm", ok=True, config=dataclasses.asdict(FULL), table_rows=FULL.total_rows,
         table_gb=FULL.total_rows * FULL.embed_dim * 4 / 1e9, init_s=init_s, seconds=time.perf_counter() - t0)
    return serve, train, dict(rows=rows, worst=worst)


DISPATCH_CALLS, DISPATCH_REPS = 200, 7      # dispatch: back-to-back calls a repetition; repetitions, median


def measure_dispatch(device: torch.device) -> dict:
    """The host cost of a kernel's custom op (`repro_torch.kernels.ops`):
    microseconds a call of K3 at serve_p99 (512 × 39 × 10) and of K1 on a
    one-block-row table (128 × 64), launched back to back (one
    synchronisation after DISPATCH_CALLS calls, so the host's cost is what
    is timed), through ``torch.ops.repro_torch.*`` and through the kernel's
    own module; the median of DISPATCH_REPS alternating repetitions."""
    from repro_torch.graph.structure import blocked_adjacency
    from repro_torch.kernels import bsr_spmm as k1
    from repro_torch.kernels import fm_interaction as k3

    r = np.random.default_rng(SEED)
    emb = torch.from_numpy(r.standard_normal((512, 39, 10)).astype(np.float32)).to(device)
    ei = r.integers(0, 128, size=(2, 1024)).astype(np.int32)
    vals, cols, lens = blocked_adjacency(128, ei, r.standard_normal(1024).astype(np.float32)).arrays(device=device)
    z = torch.from_numpy(r.standard_normal((128, 64)).astype(np.float32)).to(device)
    calls = {"k3_fm_interaction": (lambda: torch.ops.repro_torch.k3_fm_interaction(emb),
                                   lambda: k3.fm_interaction(emb)),
             "k1_bsr_spmm": (lambda: torch.ops.repro_torch.k1_bsr_spmm(vals, cols, lens, z),
                             lambda: k1.bsr_spmm(vals, cols, lens, z))}

    def per_call_us(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / DISPATCH_CALLS * 1e6

    out = {}
    with torch.no_grad():
        for name, (op, raw) in calls.items():
            op(), raw()                                     # warm-up
            times = {"custom_op_us": [], "module_us": []}
            for _ in range(DISPATCH_REPS):
                times["custom_op_us"].append(per_call_us(op))
                times["module_us"].append(per_call_us(raw))
            med = {k: statistics.median(v) for k, v in times.items()}
            out[name] = dict(med, overhead_us=med["custom_op_us"] - med["module_us"])
    emit("dispatch", ok=True, per_call=out, calls=DISPATCH_CALLS, reps=DISPATCH_REPS,
         timing="host clock over back-to-back calls, one synchronisation at the end; median of the repetitions")
    return out


def valid_pairs(S: int, window: int, causal: bool = True) -> int:
    """(query, key) pairs K4's mask keeps in one head: k > q − window, and
    k ≤ q when causal."""
    q = np.arange(S, dtype=np.int64)
    lo = np.maximum(q - window + 1, 0)
    hi = q + 1 if causal else np.full(S, S)
    return int(np.maximum(hi - lo, 0).sum())


def k4_bound(bh: int, bh_kv: int, S: int, d: int, window: int, elem: int) -> tuple[float, str]:
    """Least time of one K4 call: q, k, v read once and o written once,
    against 4·d operations per valid pair (two d-long dot products) at the
    CUDA cores' fp32 rate or, for bf16, the tensor cores' rate."""
    n_bytes = elem * S * d * (2 * bh + 2 * bh_kv)
    n_flop = 4.0 * d * bh * valid_pairs(S, window)
    return bound(n_bytes, n_flop, FP32_FLOP_PER_S if elem == 4 else BF16_FLOP_PER_S)


def sdpa_ms(q, k, v, window: int) -> tuple[float, float]:
    """(ms, max |SDPA − plain|): one `scaled_dot_product_attention` call on
    (1, H, S, d) with k and v expanded per group and K4's mask (the library
    yardstick; the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k4

    G = q.shape[0] // k.shape[0]
    S = q.shape[1]
    qh, kh, vh = q[None], k.repeat_interleave(G, 0)[None], v.repeat_interleave(G, 0)[None]
    if window >= S:
        fn = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    else:
        pos = torch.arange(S, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        fn = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    err, _ = max_err(fn()[0].float(), k4.flash_attention_plain(q, k, v, window=window).float())
    return cuda_ms(fn, reps=5), err


def sdpa_long(q, k, v, window: int, k4_out) -> dict:
    """SDPA at a length where the math backend's S × S scores do not fit (at
    S = 32,768 they take ≈ 69 GB in fp32): pinned to the memory-efficient
    backend (`torch.nn.attention.sdpa_kernel`), which streams the keys, with
    k and v expanded per group and K4's mask; one call after one warm-up, as
    K4 is timed there. Returns its ms, the backend's name and max |SDPA −
    K4|, or, where the backend refuses the shape, its error."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    G, S = q.shape[0] // k.shape[0], q.shape[1]
    qh, kh, vh = q[None], k.repeat_interleave(G, 0)[None], v.repeat_interleave(G, 0)[None]
    if window >= S:
        kw = dict(is_causal=True)
    else:
        pos = torch.arange(S, device=q.device)
        kw = dict(attn_mask=(pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window))
    backend = SDPBackend.EFFICIENT_ATTENTION
    fn = lambda: F.scaled_dot_product_attention(qh, kh, vh, **kw)
    try:
        with sdpa_kernel(backend):
            diff = float((fn()[0] - k4_out).abs().max())
            ms = cuda_ms(fn, reps=1, warmup=1)
        return dict(library_ms=ms, library_backend=backend.name, library_max_abs_diff_vs_k4=diff)
    except RuntimeError as e:           # a refusal (or out of memory) is the row's finding, not a silent None
        return dict(library_ms=None, library_backend=backend.name, library_error=f"{type(e).__name__}: {e}"[:600])
    finally:
        del qh, kh, vh, kw
        torch.cuda.empty_cache()


def global_window() -> int:
    """The LM's window of a global layer (2³⁰)."""
    from repro_torch.models.transformer_lm import GLOBAL_WINDOW

    return int(GLOBAL_WINDOW)


def check_k4(cfg, device: torch.device) -> tuple[dict, dict]:
    """(l1): K4 against its plain version on the card at gemma3-12b's
    attention shape for one sequence (16 query heads over 8 key/value heads,
    d = 240), then its times beside the plain version's, SDPA's and the
    bound; returns (the worst error per launcher, the timing rows)."""
    from repro_torch.kernels import flash_attention as k4

    H, Hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.attn.head_dim
    glob, local = global_window(), cfg.window
    gen = torch.Generator(device=device).manual_seed(SEED)
    cases, worst = [], {name: 0.0 for name in k4.LAUNCHES}

    def qkv(S, bh=H, bh_kv=Hk, dtype=torch.float32):
        return tuple(torch.randn((n, S, d), generator=gen, device=device).to(dtype) for n in (bh, bh_kv, bh_kv))

    def hold(case, q, k, v, window, causal=True):
        out = k4.flash_attention(q, k, v, window=window, causal=causal)
        ref = k4.flash_attention_plain(q, k, v, window=window, causal=causal)
        name = "k4_flash_attention" if q.dtype == torch.float32 else "k4_flash_attention_bf16"
        err, scale = max_err(out.float(), ref.float())
        row = dict(kernel=name, case=f"{case} ({q.shape[0]}/{k.shape[0]} heads × {q.shape[1]} × {d}, window "
                                     f"{window}, {'causal' if causal else 'bidirectional'})",
                   max_abs_err=err, max_abs_ref=scale, dtype=str(q.dtype).replace("torch.", ""))
        if q.dtype == torch.float32:
            row.update(rtol=KERNEL_RTOL, ok=err <= KERNEL_RTOL * scale)
        else:
            bit_equal = float((out == ref).float().mean())
            row.update(rtol=K1_BF16_STEP, bit_equal=bit_equal, bit_equal_min=K1_BF16_BIT_EQUAL,
                       ok=err <= K1_BF16_STEP * scale and bit_equal >= K1_BF16_BIT_EQUAL)
        row["ok"] = row["ok"] and out.dtype == q.dtype and out.shape == q.shape
        cases.append(row)
        worst[name] = max(worst[name], err)
        return out

    rows = {}
    with torch.inference_mode():
        q, k, v = qkv(LM_SEQ)
        for tag, window in (("global", glob), ("local", local)):
            out = hold(f"{tag} S={LM_SEQ}", q, k, v, window)
        expanded = k4.flash_attention(q, k.repeat_interleave(H // Hk, 0), v.repeat_interleave(H // Hk, 0),
                                      window=local)
        gqa_equal = bool(torch.equal(out, expanded))
        cases.append(dict(kernel="k4_flash_attention", case="GQA: 8 kv heads grouped vs expanded to 16, local",
                          bit_equal=gqa_equal, ok=gqa_equal))
        del out, expanded
        hold("odd S", *qkv(1000), glob)
        hold("S under one tile", *qkv(40), local)
        small = qkv(300, 4, 2)
        hold("window 0: every row averages v", *small, 0)
        hold("bidirectional", *small, glob, causal=False)
        hold("bidirectional, window", *small, 24, causal=False)
        for tag, window in (("global", glob), ("local", local)):
            rows[f"{tag}_{LM_SEQ}"] = dict(
                S=LM_SEQ, window=window, ms=cuda_ms(lambda: k4.flash_attention(q, k, v, window=window)),
                plain_ms=cuda_ms(lambda: k4.flash_attention_plain(q, k, v, window=window), reps=5),
                bound=k4_bound(H, Hk, LM_SEQ, d, window, 4))
            rows[f"{tag}_{LM_SEQ}"]["library_ms"], rows[f"{tag}_{LM_SEQ}"]["library_max_abs_err"] = sdpa_ms(
                q, k, v, window)
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        del q, k, v
        hold(f"bf16 global S={LM_SEQ}", qb, kb, vb, glob)
        out = hold(f"bf16 local S={LM_SEQ}", qb, kb, vb, local)
        expanded = k4.flash_attention(qb, kb.repeat_interleave(H // Hk, 0), vb.repeat_interleave(H // Hk, 0),
                                      window=local)
        gqa_equal = bool(torch.equal(out, expanded))
        cases.append(dict(kernel="k4_flash_attention_bf16", case="bf16 GQA: 8 kv heads grouped vs expanded to 16, "
                          "local", bit_equal=gqa_equal, ok=gqa_equal))
        del out, expanded
        hold("bf16 odd S", *qkv(1000, dtype=torch.bfloat16), glob)
        hold("bf16 S under one tile", *qkv(40, dtype=torch.bfloat16), local)
        bf16_rows = {}
        for tag, window in (("global", glob), ("local", local)):
            bf16_rows[f"{tag}_{LM_SEQ}"] = dict(
                S=LM_SEQ, window=window, ms=cuda_ms(lambda: k4.flash_attention(qb, kb, vb, window=window)),
                plain_ms=cuda_ms(lambda: k4.flash_attention_plain(qb, kb, vb, window=window), reps=5),
                bound=k4_bound(H, Hk, LM_SEQ, d, window, 2))
            bf16_rows[f"{tag}_{LM_SEQ}"]["library_ms"], bf16_rows[f"{tag}_{LM_SEQ}"]["library_max_abs_err"] = \
                sdpa_ms(qb, kb, vb, window)
        bf16_row = bf16_rows[f"global_{LM_SEQ}"]
        del qb, kb, vb
        q, k, v = qkv(LM_LONG_SEQ)
        for tag, window in (("global", glob), ("local", local)):
            rows[f"{tag}_{LM_LONG_SEQ}"] = dict(
                S=LM_LONG_SEQ, window=window, ms=cuda_ms(lambda: k4.flash_attention(q, k, v, window=window),
                                                         reps=1, warmup=1),
                plain_ms=None, bound=k4_bound(H, Hk, LM_LONG_SEQ, d, window, 4))
            rows[f"{tag}_{LM_LONG_SEQ}"].update(sdpa_long(q, k, v, window, k4.flash_attention(q, k, v, window=window)))
        del q, k, v
    torch.cuda.empty_cache()
    compiler = {name: k4.kernel_attributes(dtype, d) for dtype, name in
                ((torch.float32, "k4_flash_attention"), (torch.bfloat16, "k4_flash_attention_bf16"))}
    widest = k4.kernel_attributes(torch.bfloat16, k4.K4_MAX_D)      # the bf16 instantiation of d 241–256
    ok = all(c["ok"] for c in cases)
    emit("lm_kernels", ok=ok, cases=cases,
         times={k: {**v, "bound": list(v["bound"])} for k, v in
                {**rows, **{f"bf16_{key}": row for key, row in bf16_rows.items()}}.items()},
         compiler=compiler, spills=sum(c["local_bytes"] for c in compiler.values()),
         compiler_bf16_widest=widest,
         timing=f"CUDA events, median of 10 (K4) or 5 (plain, SDPA) after 2 warm-ups; S={LM_LONG_SEQ}: one launch "
                "after one warm-up, K4 and SDPA (pinned to the memory-efficient backend; no plain version: its "
                "S × S scores take ≈ 69 GB)", library="torch.nn.functional.scaled_dot_product_attention with k and "
                "v expanded per group and the same mask (is_causal for the global window)")
    require(ok, "lm_kernels", "K4 disagrees with its plain version")
    main_row = rows[f"global_{LM_SEQ}"]
    return worst, {"k4_flash_attention": {**main_row, "by_shape": rows},
                   "k4_flash_attention_bf16": {**bf16_row, "by_shape": bf16_rows}}


def lm_prefill_phase(params: dict, cfg) -> dict:
    """(l2): lm_prefill at B = 1 and S = LM_SEQ, one warm-up and three timed
    runs with the launch counts zeroed just before and read just after; the
    logits against the plain attention's; peak memory; the profiler's idle
    share over one prefill."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as k4
    from repro_torch.models.transformer_lm import lm_prefill
    from repro_torch.obs.trace import device_time_summary
    from repro_torch.train.data import token_batch_fn

    device = params["embed"].device
    tokens = torch.from_numpy(token_batch_fn(cfg.vocab, LM_SEQ)(np.random.default_rng(SEED), 1)[:, :LM_SEQ])
    tokens = tokens.to(device, torch.int64)
    windows = cfg.window_sizes()
    n_runs = 1 + LM_PREFILL_REPS
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        k4.reset_launch_counts()
        logits = lm_prefill(params, tokens, cfg)                     # warm-up
        torch.cuda.synchronize()
        prefill_ms = []
        for _ in range(LM_PREFILL_REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            logits = lm_prefill(params, tokens, cfg)
            end.record()
            end.synchronize()
            prefill_ms.append(start.elapsed_time(end))
        launches = dict(k4.LAUNCHES)
        by_window = {str(w): n for (_, w), n in k4.WINDOWS.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ref = lm_prefill(params, tokens, cfg, kernel=k4.flash_attention_plain)
        err, scale = max_err(logits, ref)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lm_prefill(params, tokens, cfg)
            torch.cuda.synchronize()
    expected = {"k4_flash_attention": n_runs * cfg.n_layers, "k4_flash_attention_bf16": 0}
    n_global = int((windows == global_window()).sum())
    expected_windows = {str(cfg.window): n_runs * (cfg.n_layers - n_global), str(global_window()): n_runs * n_global}
    checks = dict(
        launches=launches == expected, windows=by_window == expected_windows,
        shape=tuple(logits.shape) == (1, cfg.vocab), finite=bool(torch.isfinite(logits).all()),
        logits_vs_plain_attention=err <= LM_LOGIT_RTOL * scale,
        same_argmax=bool(torch.equal(logits.argmax(-1), ref.argmax(-1))),
    )
    p50 = statistics.median(prefill_ms)
    emit("lm_prefill", ok=all(checks.values()), checks=checks, batch=1, seq_len=LM_SEQ, prefills=n_runs,
         launches=launches, expected_launches=expected, launches_per_prefill=launches["k4_flash_attention"] / n_runs,
         launches_by_window=by_window, expected_by_window=expected_windows, prefill_ms=prefill_ms, p50_ms=p50,
         tokens_per_s=LM_SEQ / p50 * 1e3, logit_max_abs_err=err, max_abs_logit=scale, logit_rtol=LM_LOGIT_RTOL,
         peak_memory_gb=peak_gb, profile=dict(prefills=1, **device_time_summary(list(prof.events()), 1)),
         timing="CUDA events around each of three prefills after one warm-up; peak memory over the four")
    require(all(checks.values()), "lm_prefill", f"checks {checks}")
    return launches


def lm_decode_phase(params: dict, cfg, phase: str = "lm_decode") -> dict:
    """(l3): a ContinuousBatcher of LM_SLOTS slots serves LM_REQUESTS
    requests with the launch counts zeroed just before and read just after
    (the decode never reaches K4); step times; two requests' logits at their
    last prompt position against lm_prefill's. Emits the line ``phase``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as k4
    from repro_torch.models.transformer_lm import lm_prefill
    from repro_torch.obs.trace import device_time_summary
    from repro_torch.serve.scheduler import ContinuousBatcher, Request, decode_multi_pos

    device = params["embed"].device
    rng = np.random.default_rng(SEED + 1)
    lens = rng.integers(LM_PROMPT_LEN[0], LM_PROMPT_LEN[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    last = {}

    def sampler(logits):
        last["logits"] = logits
        return np.argmax(logits, axis=-1)

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb = ContinuousBatcher(params, cfg, n_slots=LM_SLOTS, max_len=LM_MAX_LEN, sampler=sampler)
    for rid, prompt in enumerate(prompts):
        cb.submit(Request(rid=rid, prompt=prompt, max_new_tokens=LM_NEW_TOKENS))
    first_logits, step_ms, occupancy = {}, [], []
    k4.reset_launch_counts()
    t0 = time.perf_counter()
    while cb.pending or cb.active:
        waiting = [(slot, req) for slot, req in enumerate(cb.slot_req) if req is not None and not req.generated]
        s0 = time.perf_counter()
        cb.step()                                # ends in the logits' copy to the host
        step_ms.append((time.perf_counter() - s0) * 1e3)
        occupancy.append(sum(r is not None for r in cb.slot_req))
        for slot, req in waiting:
            if req.generated:
                first_logits[req.rid] = last["logits"][slot].copy()
    total_s = time.perf_counter() - t0
    launches = dict(k4.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finished = {r.rid: r for r in cb.finished}
    held = []
    with torch.inference_mode():
        for rid in (0, 1):
            ref = lm_prefill(params, torch.from_numpy(prompts[rid][None]).to(device, torch.int64), cfg)[0].cpu().numpy()
            err, scale = float(np.abs(first_logits[rid] - ref).max()), float(np.abs(ref).max())
            top2 = np.sort(ref)[-2:]
            tie = float(top2[1] - top2[0]) <= LM_DECODE_RTOL * scale
            held.append(dict(rid=rid, prompt_len=int(lens[rid]), max_abs_err=err, max_abs_logit=scale,
                             ok=err <= LM_DECODE_RTOL * scale,
                             first_token=finished[rid].generated[0], prefill_argmax=int(ref.argmax()),
                             top2_within_rtol=tie, first_token_ok=tie or finished[rid].generated[0] == int(ref.argmax())))
        # The device's share of three decode steps of every slot, on the drained batcher's cache.
        tokens = torch.zeros(LM_SLOTS, dtype=torch.int64)
        positions = torch.full((LM_SLOTS,), LM_MAX_LEN // 2, dtype=torch.int64)
        decode_multi_pos(params, cb.cache, tokens, positions, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                decode_multi_pos(params, cb.cache, tokens, positions, cfg)[0].cpu()
            torch.cuda.synchronize()
    expected = {"k4_flash_attention": 0, "k4_flash_attention_bf16": 0}
    generated = sum(len(r.generated) for r in cb.finished)
    checks = dict(
        all_finished=sorted(finished) == list(range(LM_REQUESTS)),
        tokens_each=all(len(r.generated) == LM_NEW_TOKENS for r in cb.finished),
        no_k4_launch=launches == expected,
        logits_vs_prefill=all(h["ok"] for h in held), first_tokens=all(h["first_token_ok"] for h in held),
    )
    step_p50 = statistics.median(step_ms)
    emit(phase, ok=all(checks.values()), checks=checks, slots=LM_SLOTS, max_len=LM_MAX_LEN,
         requests=LM_REQUESTS, prompt_lens=[int(n) for n in lens], new_tokens=LM_NEW_TOKENS, steps=cb.steps_run,
         launches=launches, step_ms_p50=step_p50, step_ms_min=min(step_ms), step_ms_max=max(step_ms),
         full_step_tokens_per_s=LM_SLOTS / step_p50 * 1e3, generated_tokens=generated, total_s=total_s,
         generated_tokens_per_s=generated / total_s, mean_occupancy=float(np.mean(occupancy)),
         held_against_prefill=held, logit_rtol=LM_DECODE_RTOL, peak_memory_gb=peak_gb,
         profile=dict(decode_steps=3, **device_time_summary(list(prof.events()), 3)),
         timing="host clock around each engine step (admit, one decode step of every slot, the logits' copy to "
                "the host, sampling); a step feeds either a prompt token or a generated one")
    require(all(checks.values()), phase, f"checks {checks}")
    return launches


def run_lm(device: torch.device) -> tuple[dict, dict, dict]:
    """(l1)–(l3) at gemma3-12b's full config; returns (K4's launches in the
    prefill run, in the decode run, the timing rows and worst errors)."""
    from repro_torch.configs.gemma3_12b import FULL
    from repro_torch.models.transformer_lm import lm_init

    t0 = time.perf_counter()
    worst, rows = check_k4(FULL, device)
    t1 = time.perf_counter()
    params = lm_init(torch.Generator(device=device).manual_seed(SEED), FULL, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    n_params = sum(p.numel() for p in named_leaves(params).values())
    require(n_params == FULL.param_count(), "lm_prefill", f"{n_params} parameters, config says {FULL.param_count()}")
    emit("lm_init", ok=True, config=dataclasses.asdict(FULL), parameters=n_params,
         parameter_gb=n_params * 4 / 1e9, dtype="float32", init_s=init_s,
         memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    prefill = lm_prefill_phase(params, FULL)
    decode = lm_decode_phase(params, FULL)
    emit("lm", ok=True, seconds=time.perf_counter() - t0)
    return prefill, decode, dict(rows=rows, worst=worst)


def k4_hold(q, k, v, window: int) -> tuple[float, float]:
    """(max |K4 − plain|, max |plain|) of one K4 call on the card (outside the
    counted runs: each resets the counts just before it)."""
    from repro_torch.kernels import flash_attention as k4

    with torch.inference_mode():
        return max_err(k4.flash_attention(q, k, v, window=window), k4.flash_attention_plain(q, k, v, window=window))


def lm_tokens(vocab: int, batch: int, seq: int, device: torch.device) -> torch.Tensor:
    """(batch, seq + 1) tokens of `token_batch_fn` from the script's seed."""
    from repro_torch.train.data import token_batch_fn

    return torch.from_numpy(token_batch_fn(vocab, seq)(np.random.default_rng(SEED), batch)).to(device, torch.int64)


def train_split(tr, loss_fn, batch) -> tuple[dict, dict, dict]:
    """One step of ``tr``'s work in three timed parts (host clock, each ended
    by a synchronisation): the loss's forward, its backward, the optimizer's
    update (computed and dropped: the trainer's state is left as it was).
    Returns (ms by part, K4 launches after the forward, after the backward)."""
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.train.tree import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tr.params)]
    params = tree_unflatten(tr.params, leaves)
    torch.cuda.synchronize()
    k4.reset_launch_counts()
    t0 = time.perf_counter()
    loss = loss_fn(params, batch)
    float(loss.detach())
    t1 = time.perf_counter()
    after_forward = dict(k4.LAUNCHES, windows={str(w): n for (_, w), n in k4.WINDOWS.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)   # EGNN's last φ_x: unused
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    after_backward = dict(k4.LAUNCHES, windows={str(w): n for (_, w), n in k4.WINDOWS.items()})
    del loss, params, leaves
    with torch.no_grad():
        update = tr.opt.update(tree_unflatten(tr.params, list(grads)), tr.opt_state, tr.params)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del update, grads
    return (dict(forward_ms=(t1 - t0) * 1e3, backward_ms=(t2 - t1) * 1e3, optimizer_ms=(t3 - t2) * 1e3),
            after_forward, after_backward)


def timed_fit(tr, batch, steps: int) -> tuple[list, list]:
    """``steps`` Trainer steps on ``batch``, one `fit` call each: (losses,
    host-clock ms per step; each step ends in the loss's read-back)."""
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses += tr.fit(iter([batch]), max_steps=tr.step + 1, log=lambda line: None)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms


def profile_fit(tr, batch, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.trace import device_time_summary

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.fit(iter([batch] * steps), max_steps=tr.step + steps, log=lambda line: None)
        torch.cuda.synchronize()
    return dict(steps=steps, **device_time_summary(list(prof.events()), steps))


def run_lm_train(device: torch.device) -> tuple[dict, float]:
    """lm_train: gemma3-12b at its full widths, depth cut to LM_TRAIN_LAYERS:
    (a) one lm_loss gradient at B = 1 with K4 in the forward and
    flash_attention_vjp behind it against the same loss with the plain
    attention and autograd; (b) a Trainer's AdamW steps with the launch
    counts zeroed just before and read just after; (c) K4's launches in one
    step's forward (one a layer, by window) and none in its backward;
    (d) step times, the forward / backward / optimizer split, the attention
    backward's ms a layer against K4's forward, peak memory, the profile.
    Returns (K4's launches over the Trainer's steps, the worst K4 error)."""
    from repro_torch.configs.gemma3_12b import FULL
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.models.transformer_lm import lm_init, lm_loss
    from repro_torch.train.loop import Trainer, TrainerConfig, value_and_grad
    from repro_torch.train.optimizer import adamw

    t0 = time.perf_counter()
    cfg = dataclasses.replace(FULL, n_layers=LM_TRAIN_LAYERS)
    reduced = {"n_layers": f"{FULL.n_layers} → {LM_TRAIN_LAYERS}"}
    params = lm_init(torch.Generator(device=device).manual_seed(SEED), cfg, device=device)
    n_params = sum(p.numel() for p in named_leaves(params).values())
    require(n_params == cfg.param_count(), "lm_train", f"{n_params} parameters, config says {cfg.param_count()}")
    tokens = lm_tokens(cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ, device)
    windows = [int(w) for w in cfg.window_sizes()]
    loss_fn = lambda p, b: lm_loss(p, b, cfg)

    # (a) the gradient through K4 and flash_attention_vjp against the plain attention's autograd, at B = 1
    k4.reset_launch_counts()
    loss_k4, g_k4 = value_and_grad(loss_fn, params, tokens[:1])
    grad_launches = dict(k4.LAUNCHES)
    loss_plain, g_plain = value_and_grad(lambda p, b: lm_loss(p, b, cfg, kernel=k4.flash_attention_plain),
                                         params, tokens[:1])
    leaf_errs, got = {}, named_leaves(g_k4)
    for name, want in named_leaves(g_plain).items():
        err, scale = max_err(got[name], want)
        leaf_errs[name] = dict(max_abs_err=err, max_abs_grad=scale, rel=err / scale if scale else float("inf"))
    del g_k4, g_plain, got
    gc.collect()
    torch.cuda.empty_cache()

    # K4 against its plain version at this path's shapes (B = 2: 32 query heads over 16 kv heads)
    H, Hk, d = LM_TRAIN_BATCH * cfg.n_heads, LM_TRAIN_BATCH * cfg.n_kv_heads, cfg.attn.head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    q, k, v = (torch.randn((n, LM_TRAIN_SEQ, d), generator=gen, device=device) for n in (H, Hk, Hk))
    g = torch.randn((H, LM_TRAIN_SEQ, d), generator=gen, device=device)
    held, attn = {}, {}
    for tag, window in (("local", cfg.window), ("global", global_window())):
        err, scale = k4_hold(q, k, v, window)
        held[tag] = dict(max_abs_err=err, max_abs_ref=scale, ok=err <= KERNEL_RTOL * scale)
        with torch.inference_mode():
            out = k4.flash_attention(q, k, v, window=window)
            attn[tag] = dict(window=window, k4_forward_ms=cuda_ms(lambda: k4.flash_attention(q, k, v, window=window),
                                                                  reps=5),
                             vjp_ms=cuda_ms(lambda: k4.flash_attention_vjp(q, k, v, out, g, window), reps=3,
                                            warmup=1))
        attn[tag]["vjp_over_forward"] = attn[tag]["vjp_ms"] / attn[tag]["k4_forward_ms"]
    k4.reset_launch_counts()
    del q, k, v, g, out
    torch.cuda.empty_cache()

    # (b) the Trainer's steps, counted from zero
    tr = Trainer(loss_fn, adamw(LM_TRAIN_LR), params, TrainerConfig(log_every=10**9))
    del params
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k4.reset_launch_counts()
    losses, step_ms = timed_fit(tr, tokens, LM_TRAIN_STEPS)
    launches = dict(k4.LAUNCHES)
    by_window = {str(w): n for (_, w), n in k4.WINDOWS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # (c) one step's work split; K4 launches after its forward and after its backward
    split, after_forward, after_backward = train_split(tr, loss_fn, tokens)
    k4.reset_launch_counts()
    # (d) the profile
    prof = profile_fit(tr, tokens, LM_TRAIN_PROFILE_STEPS)
    k4.reset_launch_counts()
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    n_local = sum(w == cfg.window for w in windows)
    per_forward = {"k4_flash_attention": LM_TRAIN_LAYERS, "k4_flash_attention_bf16": 0,
                   "windows": {str(cfg.window): n_local, str(global_window()): LM_TRAIN_LAYERS - n_local}}
    expected = {"k4_flash_attention": LM_TRAIN_STEPS * LM_TRAIN_LAYERS, "k4_flash_attention_bf16": 0}
    expected_windows = {k: LM_TRAIN_STEPS * n for k, n in per_forward["windows"].items()}
    worst_rel = max(e["rel"] for e in leaf_errs.values())
    checks = dict(
        gradient_vs_plain_attention=worst_rel <= LM_TRAIN_GRAD_RTOL,
        gradient_launches=grad_launches == {k: v for k, v in per_forward.items() if k != "windows"},
        loss_vs_plain_attention=abs(float(loss_k4) - float(loss_plain)) <= LM_TRAIN_GRAD_RTOL * abs(float(loss_plain)),
        k4_vs_plain=all(h["ok"] for h in held.values()),
        finite_losses=all(np.isfinite(losses)), loss_falls=losses[-1] < losses[0],
        launches=launches == expected, windows=by_window == expected_windows,
        forward_launches=after_forward == per_forward, no_backward_launch=after_backward == after_forward,
    )
    emit("lm_train", ok=all(checks.values()), checks=checks, config=dataclasses.asdict(cfg), reduced=reduced,
         parameters=n_params, parameter_gb=n_params * 4 / 1e9, batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
         windows=windows, loss_k4=float(loss_k4), loss_plain_attention=float(loss_plain),
         gradient_rel_err_max=worst_rel, gradient_rtol=LM_TRAIN_GRAD_RTOL, gradient_by_leaf=leaf_errs,
         k4_vs_plain=held, losses=losses, step_ms=step_ms, step_ms_median=statistics.median(step_ms),
         tokens_per_s=LM_TRAIN_BATCH * LM_TRAIN_SEQ / statistics.median(step_ms) * 1e3,
         split=split, launches=launches, expected_launches=expected, launches_by_window=by_window,
         launches_after_forward=after_forward, launches_after_backward=after_backward,
         attention_per_layer=attn, peak_memory_gb=peak_gb, profile=prof, seconds=time.perf_counter() - t0,
         timing="host clock around each Trainer step (ends in the loss's read-back); the split: one more step's "
                "forward, backward and update, each ended by a synchronisation; attention: CUDA-event medians at "
                "B = 2 (32 query / 16 kv heads × 2,048 × 240) of K4's forward and of flash_attention_vjp")
    require(all(checks.values()), "lm_train", f"checks {checks}")
    return launches, max(h["max_abs_err"] for h in held.values())


def run_moe(device: torch.device) -> tuple[dict, float]:
    """moe: olmoe-1b-7b. At its full config (16 layers, served whole): (a)
    teacher-forced decode against lm_forward; (b) prefill 1 × 4,096 with
    the launch counts zeroed just before and read just after, the (token,
    expert) pairs capacity drops in each layer; (c) the ContinuousBatcher
    (`lm_decode_phase`, line ``moe_decode``). Then (d) training at its
    widths with the depth cut to MOE_TRAIN_LAYERS. Returns (K4's launches
    over the prefills and the training steps, the worst K4 error)."""
    from repro_torch.configs.olmoe_1b_7b import FULL
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.models.transformer_lm import lm_decode_step, lm_forward, lm_init, lm_init_cache, lm_loss, lm_prefill
    from repro_torch.nn import moe
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import adamw

    t0 = time.perf_counter()
    cfg = FULL
    params = lm_init(torch.Generator(device=device).manual_seed(SEED), cfg, device=device)
    n_params = sum(p.numel() for p in named_leaves(params).values())
    require(n_params == cfg.param_count(), "moe_serve", f"{n_params} parameters, config says {cfg.param_count()}")
    init_gb = torch.cuda.memory_allocated() / 1e9

    # (a) teacher-forced decode against the forward on the same tokens
    toks = lm_tokens(cfg.vocab, MOE_DECODE_BATCH, MOE_DECODE_LEN, device)[:, :MOE_DECODE_LEN]
    with torch.inference_mode():
        cache = lm_init_cache(cfg, MOE_DECODE_BATCH, MOE_DECODE_LEN, device=device)
        steps = [lm_decode_step(params, cache, toks[:, t], t, cfg)[0] for t in range(MOE_DECODE_LEN)]
        forward, _ = lm_forward(params, toks, cfg)
        dec_err, dec_scale = max_err(torch.stack(steps, 1), forward)
        same_argmax = float((torch.stack(steps, 1).argmax(-1) == forward.argmax(-1)).float().mean())
    del cache, steps, forward

    # (b) prefill 1 × MOE_PREFILL_SEQ: K4 at d 128, every layer global; the pairs capacity drops
    tokens = lm_tokens(cfg.vocab, 1, MOE_PREFILL_SEQ, device)[:, :MOE_PREFILL_SEQ]
    H, d = cfg.n_heads, cfg.attn.head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    q, k, v = (torch.randn((H, MOE_PREFILL_SEQ, d), generator=gen, device=device) for _ in range(3))
    err, scale = k4_hold(q, k, v, global_window())
    held = dict(max_abs_err=err, max_abs_ref=scale, ok=err <= KERNEL_RTOL * scale,
                shape=f"{H}/{H} heads × {MOE_PREFILL_SEQ} × {d}, global")
    del q, k, v
    n_runs = 1 + LM_PREFILL_REPS
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = []
    with torch.inference_mode():
        k4.reset_launch_counts()
        lm_prefill(params, tokens, cfg)                                # warm-up
        for _ in range(LM_PREFILL_REPS):
            moe.RECORD = []
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            logits = lm_prefill(params, tokens, cfg)
            end.record()
            end.synchronize()
            prefill_ms.append(start.elapsed_time(end))
        launches_prefill = dict(k4.LAUNCHES)
        by_window = {str(w): n for (_, w), n in k4.WINDOWS.items()}
    dropped = [int(r["dropped"]) for r in moe.RECORD]
    moe.RECORD = None
    peak_prefill_gb = torch.cuda.max_memory_allocated() / 1e9
    capacity = cfg.moe_cfg().capacity(MOE_PREFILL_SEQ)
    expected_prefill = {"k4_flash_attention": n_runs * cfg.n_layers, "k4_flash_attention_bf16": 0}
    checks = dict(
        parameters=n_params == cfg.param_count(),
        decode_vs_forward=dec_err <= MOE_DECODE_RTOL * dec_scale,
        k4_vs_plain=held["ok"], launches=launches_prefill == expected_prefill,
        windows=by_window == {str(global_window()): n_runs * cfg.n_layers},
        logits=tuple(logits.shape) == (1, cfg.vocab) and bool(torch.isfinite(logits).all()),
        dropped_per_layer=len(dropped) == cfg.n_layers,
    )
    emit("moe_serve", ok=all(checks.values()), checks=checks, config=dataclasses.asdict(cfg),
         parameters=n_params, param_count=cfg.param_count(), parameter_gb=n_params * 4 / 1e9,
         memory_allocated_gb=init_gb, decode_tokens=[MOE_DECODE_BATCH, MOE_DECODE_LEN],
         decode_max_abs_err=dec_err, max_abs_logit=dec_scale, decode_rtol=MOE_DECODE_RTOL,
         decode_same_argmax=same_argmax, k4_vs_plain=held, prefill_seq=MOE_PREFILL_SEQ, prefills=n_runs,
         prefill_ms=prefill_ms, prefill_p50_ms=statistics.median(prefill_ms), launches=launches_prefill,
         expected_launches=expected_prefill, launches_by_window=by_window, capacity=capacity,
         dropped_pairs_per_layer=dropped, assignments_per_layer=MOE_PREFILL_SEQ * cfg.moe_top_k,
         dropped_share=sum(dropped) / (cfg.n_layers * MOE_PREFILL_SEQ * cfg.moe_top_k),
         peak_memory_gb=peak_prefill_gb,
         timing="CUDA events around each of three prefills after one warm-up")
    require(all(checks.values()), "moe_serve", f"checks {checks}")

    # (c) the ContinuousBatcher
    decode_launches = lm_decode_phase(params, cfg, phase="moe_decode")
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()

    # (d) training at MOE_TRAIN_LAYERS layers
    tcfg = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
    params = lm_init(torch.Generator(device=device).manual_seed(SEED), tcfg, device=device)
    batch = lm_tokens(tcfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ, device)
    tr = Trainer(lambda p, b: lm_loss(p, b, tcfg), adamw(LM_TRAIN_LR), params, TrainerConfig(log_every=10**9))
    del params
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k4.reset_launch_counts()
    losses, step_ms, aux, dropped = [], [], [], []
    for _ in range(MOE_TRAIN_STEPS):
        moe.RECORD = []
        step_losses, ms = timed_fit(tr, batch, 1)
        losses += step_losses
        step_ms += ms
        aux.append(float(sum(r["aux"] for r in moe.RECORD)))
        dropped.append(int(sum(r["dropped"] for r in moe.RECORD)))
    moe.RECORD = None
    launches_train = dict(k4.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_train = sum(p.numel() for p in named_leaves(tr.params).values())
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    expected_train = {"k4_flash_attention": MOE_TRAIN_STEPS * MOE_TRAIN_LAYERS, "k4_flash_attention_bf16": 0}
    tchecks = dict(finite_losses=all(np.isfinite(losses)), loss_falls=losses[-1] < losses[0],
                   launches=launches_train == expected_train, parameters=n_train == tcfg.param_count())
    emit("moe_train", ok=all(tchecks.values()), checks=tchecks, config=dataclasses.asdict(tcfg),
         reduced={"n_layers": f"{cfg.n_layers} → {MOE_TRAIN_LAYERS}"}, parameters=n_train,
         parameter_gb=n_train * 4 / 1e9, batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
         capacity=tcfg.moe_cfg().capacity(LM_TRAIN_BATCH * LM_TRAIN_SEQ), losses=losses, aux_per_step=aux,
         dropped_pairs_per_step=dropped, step_ms=step_ms, step_ms_median=statistics.median(step_ms),
         launches=launches_train, expected_launches=expected_train, peak_memory_gb=peak_gb,
         timing="host clock around each Trainer step (ends in the loss's read-back)")
    require(all(tchecks.values()), "moe_train", f"checks {tchecks}")
    launches = {name: launches_prefill[name] + decode_launches[name] + launches_train[name] for name in k4.LAUNCHES}
    emit("moe", ok=True, seconds=time.perf_counter() - t0)
    return launches, held["max_abs_err"]


# ------------------------------------------------- the sharded LM and DeepFM (build_cell over a 4-rank group)
SHARDED_K = 4
SHARDED_TIMEOUT_S = 720.0
SHARDED_SEQ = 4096               # lm_tp, moe_ep: prefill 1 × 4,096
SHARDED_CACHE = 4096             # lm_tp, moe_ep: the decode cell's cache length (seeded, as a prefill's keys/values)
SHARDED_DECODE_BATCH = 4         # every decode phase: B 4
SHARDED_DECODE_STEPS = 4         # every decode phase: steps after the prefill (8 → 4: the script's time limit)
SHARDED_PREFILLS = 1             # counted prefills a rank (gloo makes each ~8 s); a decode step is profiled
LM_SEQ_CACHE = 32_768            # lm_seq: granite-34b's cache, sharded by sequence (4 slices of 8,192)
LM_SEQ_LAYERS = 8                # lm_seq: granite-34b's depth cut 88 → 8 (93.9 GB bf16 whole fits no card)
MOE_EP_LAYERS = 6                # moe_ep: moonshot-v1-16b-a3b's depth cut 48 → 6 (the script's time limit; widths
                                 # whole)
LM_TP_LAYERS = 6                 # lm_tp: gemma3-12b's depth cut 48 → 6, one 5 local : 1 global period (the script's
                                 # time limit: 97 all-reduces of 3.05 GB a rank through gloo at 48; widths whole)
CUT_REASONS = {"lm_tp": "the script's time limit (48 layers: 97 all-reduces of 3.05 GB a rank through gloo, "
                        "7.9–12.1 s a prefill a rank)",
               "moe_ep": "the script's time limit",
               "lm_seq": "93.9 GB of bf16 weights whole fit no card",
               "lm_tp_train": "fp32 weights, gradients and AdamW state of 48 layers fit no card"}
SHARDED_LOGIT_RTOL = 5e-2        # bf16 sharded vs unsharded logits, · max |logit| (the parity contract)
SHARDED_TRAIN_STEPS = 2          # lm_tp_train: AdamW steps (the cell's lr 3e-4; 3 → 2: the script's time limit)
SHARDED_GRAD_RTOL = 1e-4         # lm_tp_train, deepfm_sharded: first gradients vs unsharded, · max per leaf
SHARDED_LOSS_RTOL = 1e-4         # lm_tp_train, deepfm_sharded: every loss (before and after each step) vs unsharded, relative
MOE_LAYER_RTOL = 5e-2            # moe_ep: each MoE layer alone on one input, expert parallel vs unsharded, · max |out|
                                 # of the layer (the parity contract's bf16 rule: the same routing, the bf16 combine's
                                 # sum reassociated over 8 M outputs)
MOE_LAYER_SHARED = 0.3           # moe_ep: the weight of one direction every token of that input shares (the rest
                                 # unit noise): tokens that lean alike load some experts past capacity, as a model's
                                 # hidden states do (≈ 13 % of pairs dropped, simulating moonshot's router at random init)
DEEPFM_SHARDED_STEPS = 2         # deepfm_sharded: AdamW steps at train_batch (the cell's lr 1e-3; 5 → 2: the
                                 # script's time limit)


# ------------------------------------------------------------------ the dry run
DRYRUN_SWEEP = (("pna", "full_graph_sm", {}), ("pna", "molecule", {}), ("pna", "minibatch_lg", {}),
                ("equiformer-v2", "full_graph_sm", {}), ("equiformer-v2", "minibatch_lg", {}),
                ("coin_gcn", "cora", {"optimized": True}), ("coin_gcn", "cora", {"payload": "int8"}),
                ("gemma3-12b", "train_4k", {}), ("gemma3-12b", "decode_32k", {}),
                ("moonshot-v1-16b-a3b", "train_4k", {"optimized": True}),
                ("deepfm", "train_batch", {}), ("deepfm", "retrieval_cand", {}))   # (a), on 16 × 16 and 2 × 16 × 16
DRYRUN_K = 4                     # (b): one gloo group of 4 ranks on the card
DRYRUN_TIMEOUT_S = 720.0        # the group (its GNN steps, then the hillclimb's cells) and each host part
DRYRUN_LOSS_RTOL = 1e-4          # (c): fp32-wire 4-rank loss vs the k = 1 cell's, relative
DRYRUN_HOLD_RTOL = 1e-4          # (c): each gradient leaf, and each parameter leaf after the AdamW step, · max |·|
DRYRUN_SIGN_FLOOR = {"float32": 1e-4, "float64": 0.0}
                                 # (c): a parameter is held where its k = 1 gradient is ≥ this · the leaf's max |g|:
                                 #      a first AdamW step moves each parameter by lr·sign(g), so an fp32 gradient
                                 #      that is rounding noise (|g| ≈ 1e-7 of the leaf's max) may step the other way;
                                 #      float64 (PNA's cells) holds every parameter
DRYRUN_WIRE_LOSS_RTOL = 1e-2     # (c): bf16 / int8 wire losses vs fp32, relative (tests/test_overlap_halo.py's 1 % L2)


def sharded_phases() -> list[dict]:
    """The five phases of the 4-rank group, as picklable descriptions."""
    return [
        dict(name="lm_tp", family="lm", arch="gemma3-12b", layers=LM_TP_LAYERS, dtype="bfloat16", grid=(1, 4),
             prefill=True, cache=SHARDED_CACHE),
        dict(name="moe_ep", family="lm", arch="moonshot-v1-16b-a3b", layers=MOE_EP_LAYERS, dtype="bfloat16",
             grid=(1, 4), prefill=True, cache=SHARDED_CACHE),
        dict(name="lm_seq", family="lm", arch="granite-34b", layers=LM_SEQ_LAYERS, dtype="bfloat16", grid=(1, 4),
             prefill=False, cache=LM_SEQ_CACHE),
        dict(name="lm_tp_train", family="lm_train", arch="gemma3-12b", layers=LM_TRAIN_LAYERS, dtype="float32",
             grid=(1, 4)),
        dict(name="deepfm_sharded", family="recsys", arch="deepfm", layers=None, dtype="float32", grid=(2, 2)),
    ]


def phase_cells(phase: dict, grid) -> dict:
    """The phase's cells (`build_cell`) on ``grid``, by role."""
    from repro_torch.configs.registry import ShapeSpec, get_arch, recsys_shapes
    from repro_torch.launch.steps import build_cell

    spec = get_arch(phase["arch"])
    if phase["layers"]:
        cut = dataclasses.replace(spec.make_config(), n_layers=phase["layers"])
        spec = dataclasses.replace(spec, make_config=lambda shape=None, c=cut: c)
    dtype = getattr(torch, phase["dtype"])
    build = lambda shape: build_cell(spec, shape, grid, dtype=dtype)
    if phase["family"] == "lm":
        cells = {"decode": build(ShapeSpec("decode", "decode", seq_len=phase["cache"],
                                           global_batch=SHARDED_DECODE_BATCH))}
        if phase["prefill"]:
            cells["prefill"] = build(ShapeSpec("prefill", "prefill", seq_len=SHARDED_SEQ, global_batch=1))
        return cells
    if phase["family"] == "lm_train":
        return {"train": build(ShapeSpec("train", "train", seq_len=LM_TRAIN_SEQ, global_batch=LM_TRAIN_BATCH))}
    shapes = recsys_shapes()
    return {"serve": build(shapes["serve_p99"]), "bulk": build(shapes["serve_bulk"]),
            "retrieval": build(shapes["retrieval_cand"]), "train": build(shapes["train_batch"])}


def phase_reduced(phase: dict) -> dict:
    from repro_torch.configs.registry import get_arch

    out = {}
    if phase["layers"]:
        out["n_layers"] = (f"{get_arch(phase['arch']).make_config().n_layers} → {phase['layers']} "
                           f"({CUT_REASONS[phase['name']]}); widths whole")
    if phase["family"] == "lm":
        out["decode"] = (f"B {SHARDED_DECODE_BATCH} × a {phase['cache']}-slot cache, {SHARDED_DECODE_STEPS} steps "
                         "(8 → 4: the script's time limit)")
        if phase["prefill"]:
            out["prefill"] = f"prefill_32k's 32 × 32,768 → 1 × {SHARDED_SEQ}"
    if phase["family"] == "lm_train":
        out["batch"] = f"train_4k's 256 × 4,096 → {LM_TRAIN_BATCH} × {LM_TRAIN_SEQ}"
        out["steps"] = f"3 → {SHARDED_TRAIN_STEPS} AdamW steps (the script's time limit)"
    if phase["family"] == "recsys":
        out["steps"] = f"5 → {DEEPFM_SHARDED_STEPS} AdamW steps (the script's time limit)"
    return out


def decode_tokens(vocab: int, step: int) -> np.ndarray:
    """The B tokens fed at decode step ``step`` (the same in every run)."""
    return np.random.default_rng(SEED + 20 + step).integers(0, vocab, SHARDED_DECODE_BATCH).astype(np.int64)


def step_profile(events: list) -> dict:
    """`device_time_summary` of one profiled step, with the kernels' own busy
    ms beside: the device timeline also holds the copies that stage every
    gloo collective through the host, which run on the copy engines, beside
    the other ranks' kernels."""
    from repro_torch.obs.trace import device_time_summary

    out = device_time_summary(events, 1, top=5)
    busy, copies, last = 0.0, 0.0, float("-inf")
    spans = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith("ProfilerStep"):
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            copies += e.time_range.elapsed_us()
        else:
            spans.append((e.time_range.start, e.time_range.end))
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    return dict(out, kernel_busy_ms=busy / 1e3, copy_ms=copies / 1e3)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device: torch.device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _host_tree(tree) -> dict:
    """Every leaf as an fp32 host tensor: a rank's result crosses to the
    parent through shared memory (torch's queue reductions), where numpy
    arrays would stream through a pipe (170 s for lm_tp_train's 9.3 GB)."""
    return {name: leaf.detach().float().cpu() for name, leaf in named_leaves(tree).items()}


def run_lm_serve(cells: dict, phase: dict, device: torch.device, policy=None) -> dict:
    """Prefill (counted) and SHARDED_DECODE_STEPS decode steps (the last
    once more under the profiler) of one LM cell pair — unsharded in the parent, a rank's share in
    the group (``policy`` bound). Returns the outputs (the vocab shards
    gathered), times, K4 launches, the dropped pairs per layer and the
    routing margin, the collectives a step and the peak memory; for an MoE
    model also `run_moe_layers`."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist import policy as pol
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.nn import moe
    from repro_torch.obs.trace import device_time_summary

    gather = (lambda x: policy.model_gather(x)) if policy is not None else (lambda x: x)
    out = {}
    dec = cells["decode"]
    params = None
    if "prefill" in cells:
        params, tokens = cells["prefill"].make_inputs(SEED, device)
    params, cache, _, pos0 = dec.make_inputs(SEED, device, params=params)
    cfg = dec.cfg
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        if "prefill" in cells:
            fn = cells["prefill"].fn
            k4.reset_launch_counts()
            moe.RECORD, pol.STATS, ms = [], {}, []
            for _ in range(SHARDED_PREFILLS):
                moe.RECORD = []
                pol.STATS, pol.COLLECTIVES = {}, {}
                logits, t = _timed(lambda: fn(params, tokens), device)
                ms.append(t)
            stats, record, by_kind = pol.STATS, moe.RECORD, pol.COLLECTIVES
            moe.RECORD = pol.STATS = pol.COLLECTIVES = None
            out["prefill_by_kind"] = by_kind
            out["prefill_launches"] = dict(k4.LAUNCHES)
            out["prefill_windows"] = {str(w): n for (_, w), n in k4.WINDOWS.items()}
            out["prefill_ms"] = ms
            out["prefill_collectives"] = stats
            out["dropped_per_layer"] = [int(r["dropped"]) for r in record]
            out["margin_per_layer"] = [float(r["margin"]) for r in record]
            out["experts_per_layer"] = [r["experts"].cpu().numpy() for r in record]
            out["prefill_logits"] = gather(logits).float().cpu().numpy()
            del logits, tokens
        fn = dec.fn
        k4.reset_launch_counts()
        steps, ms, stats, experts = [], [], [], []
        for step in range(SHARDED_DECODE_STEPS):
            whole = decode_tokens(cfg.vocab, step)
            tok_spec = dec.in_specs[2]
            token = torch.from_numpy(np.ascontiguousarray(dec.cut(whole, tok_spec))).to(device)
            pol.STATS, moe.RECORD = {}, ([] if cfg.is_moe else None)
            (logits, cache), t = _timed(lambda: fn(params, cache, token, pos0 + step), device)
            stats.append(pol.STATS)
            if cfg.is_moe:
                experts.append(np.stack([r["experts"].cpu().numpy() for r in moe.RECORD]))
            pol.STATS = moe.RECORD = None
            ms.append(t)
            steps.append(gather(logits).float().cpu().numpy())
        out["decode_launches"] = dict(k4.LAUNCHES)
        if experts:
            out["decode_experts"] = np.stack(experts)          # (steps, layers, B, K)
        out["decode_ms"] = ms
        out["decode_collectives"] = stats[-1]
        out["decode_logits"] = np.stack(steps)
        out["positions"] = [pos0 + s for s in range(SHARDED_DECODE_STEPS)]
        with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                                          else [])) as prof:
            fn(params, cache, token, pos0)           # the last step again, under the profiler
            _sync(device)
        out["decode_profile"] = step_profile(list(prof.events()))
        if cfg.is_moe:
            out.update(run_moe_layers(params, cfg, device, policy))
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None
    out["parameters_gb"] = sum(p.numel() * p.element_size() for p in named_leaves(params).values()) / 1e9
    del params, cache
    return out


def run_moe_layers(params: dict, cfg, device: torch.device, policy=None) -> dict:
    """Every MoE layer of the model alone (`moe_apply` on its weights, the
    rank's experts under ``policy``) on one seeded (SHARDED_SEQ, d_model)
    input whose tokens share a direction (MOE_LAYER_SHARED), so that
    capacity drops pairs: with the same input the routing is the same in the unsharded
    and the expert-parallel run, and the two functions differ only by the
    combine's sum over the model group. Returns each layer's output (bf16,
    on the host), expert ids, dropped pairs and routing margin."""
    from repro_torch.nn import moe

    gen = torch.Generator().manual_seed(SEED + 30)
    shared, noise = torch.randn((cfg.d_model,), generator=gen), torch.randn((SHARDED_SEQ, cfg.d_model), generator=gen)
    x = (MOE_LAYER_SHARED * shared + (1.0 - MOE_LAYER_SHARED**2) ** 0.5 * noise).to(device, params["embed"].dtype)
    stacked, moe_cfg = params["layers"]["moe"], cfg.moe_cfg()
    outs, experts, dropped, margin = [], [], [], []
    for i in range(cfg.n_layers):
        moe.RECORD = []
        y, _ = moe.moe_apply({name: leaf[i] for name, leaf in stacked.items()}, x, moe_cfg, policy)
        (rec,), moe.RECORD = moe.RECORD, None
        outs.append(y.cpu())
        experts.append(rec["experts"].cpu().numpy())
        dropped.append(int(rec["dropped"]))
        margin.append(float(rec["margin"]))
    return dict(moe_layer_out=torch.stack(outs), moe_layer_experts=np.stack(experts), moe_layer_dropped=dropped,
                moe_layer_margin=margin)


def moe_layer_hold(res: list, ref: dict) -> tuple[dict, dict]:
    """`run_moe_layers` of every rank against the unsharded run's: the
    expert ids and dropped pairs of every layer equal (and some pairs
    dropped, so that the hold reaches the capacity rule), and every
    layer's output within MOE_LAYER_RTOL of its largest entry."""
    got, want = res[0]["moe_layer_out"].float(), ref["moe_layer_out"].float()
    scale = want.abs().amax(dim=(1, 2))
    rel = ((got - want).abs().amax(dim=(1, 2)) / scale).tolist()
    line = dict(moe_layers_out_rel_err=rel, moe_layers_rtol=MOE_LAYER_RTOL,
                moe_layers_dropped=res[0]["moe_layer_dropped"], unsharded_moe_layers_dropped=ref["moe_layer_dropped"],
                moe_layers_margin_min=min(res[0]["moe_layer_margin"]),
                unsharded_moe_layers_margin_min=min(ref["moe_layer_margin"]),
                moe_layers_input=f"one seeded ({SHARDED_SEQ}, d_model) bf16 input through each of the layers, "
                                 f"{MOE_LAYER_SHARED} of one shared direction + unit noise")
    checks = dict(moe_layers_routing=all(np.array_equal(r["moe_layer_experts"], ref["moe_layer_experts"]) for r in res),
                  moe_layers_dropped=all(r["moe_layer_dropped"] == ref["moe_layer_dropped"] for r in res)
                  and sum(ref["moe_layer_dropped"]) > 0,
                  moe_layers_out=got.shape == want.shape and bool(torch.isfinite(got).all())
                  and max(rel) <= MOE_LAYER_RTOL)
    return line, checks


def run_lm_train_cell(cells: dict, device: torch.device, policy=None) -> dict:
    """The first gradient of the train cell's loss (before any step), then
    SHARDED_TRAIN_STEPS steps of its fn (AdamW), the last under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist import policy as pol
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.models.transformer_lm import lm_loss
    from repro_torch.obs.trace import device_time_summary
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.tree import tree_map

    cell = cells["train"]
    params, state, tokens = cell.make_inputs(SEED, device)
    loss0, grads = value_and_grad(lambda p, b: lm_loss(p, b, cell.cfg, cell.policy), params, tokens)
    if policy is not None and policy.n_data > 1:
        grads = tree_map(policy.data_psum, grads)
    out = {"grads": _host_tree(grads), "loss0": float(loss0)}
    del grads
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    fn = cell.fn
    k4.reset_launch_counts()
    losses, ms, stats = [], [], []
    for step in range(SHARDED_TRAIN_STEPS):
        pol.STATS = {}
        if step == SHARDED_TRAIN_STEPS - 1:
            with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                                              else [])) as prof:
                (params, state, loss), t = _timed(lambda: fn(params, state, tokens), device)
            out["profile"] = step_profile(list(prof.events()))
        else:
            (params, state, loss), t = _timed(lambda: fn(params, state, tokens), device)
        stats.append(pol.STATS)
        pol.STATS = None
        losses.append(float(loss))
        ms.append(t)
    out.update(launches=dict(k4.LAUNCHES), windows={str(w): n for (_, w), n in k4.WINDOWS.items()}, losses=losses,
               step_ms=ms, collectives=stats[0],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None)
    del params, state, tokens
    return out


def run_deepfm_cells(cells: dict, device: torch.device, policy=None) -> dict:
    """serve_p99 (one warm-up, DEEPFM_REQUESTS timed), serve_bulk,
    retrieval (1 × 10⁶) and the first gradient then DEEPFM_SHARDED_STEPS
    AdamW steps at train_batch, the last under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist import policy as pol
    from repro_torch.kernels import fm_interaction as k3
    from repro_torch.models.deepfm import deepfm_loss
    from repro_torch.obs.trace import device_time_summary
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.tree import tree_map

    gather = (lambda x, dim=-1: policy.model_gather(x, dim)) if policy is not None else (lambda x, dim=-1: x)
    out = {}
    params, ids = cells["serve"].make_inputs(SEED, device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    k3.reset_launch_counts()
    with torch.inference_mode():
        fn = cells["serve"].fn
        fn(params, ids)
        ms = []
        for _ in range(DEEPFM_REQUESTS):
            pol.STATS, pol.COLLECTIVES = {}, {}
            logits, t = _timed(lambda: fn(params, ids), device)
            ms.append(t)
        out.update(serve_ms=ms, serve_collectives=pol.STATS, serve_by_kind=pol.COLLECTIVES,
                   serve_logits=logits.cpu().numpy())
        _, bulk_ids = cells["bulk"].make_inputs(SEED, device, params=params)
        pol.STATS, pol.COLLECTIVES = {}, {}
        logits, t = _timed(lambda: cells["bulk"].fn(params, bulk_ids), device)
        out.update(bulk_ms=t, bulk_collectives=pol.STATS, bulk_by_kind=pol.COLLECTIVES,
                   bulk_logits=logits.cpu().numpy())
        del bulk_ids, logits
        _, user, cands = cells["retrieval"].make_inputs(SEED, device, params=params)
        pol.STATS, pol.COLLECTIVES = {}, {}
        scores, t = _timed(lambda: cells["retrieval"].fn(params, user, cands), device)
        # The call's own collectives: the scores gathered whole for the check come after.
        out.update(retrieval_ms=t, retrieval_collectives=pol.STATS, retrieval_by_kind=pol.COLLECTIVES)
        pol.STATS = pol.COLLECTIVES = None
        out["retrieval_scores"] = gather(scores, 1).cpu().numpy()
        del user, cands, scores
    pol.STATS = pol.COLLECTIVES = None
    out["serve_launches"] = dict(k3.LAUNCHES)
    cell = cells["train"]
    _, state, ids, labels = cell.make_inputs(SEED, device, params=params)
    loss0, grads = value_and_grad(lambda p, b: deepfm_loss(p, b[0], b[1], cell.cfg, cell.policy), params,
                                  (ids, labels))
    if policy is not None and policy.n_data > 1:
        grads = tree_map(policy.data_psum, grads)
    out.update(grads=_host_tree(grads), loss0=float(loss0))
    del grads
    fn = cell.fn
    k3.reset_launch_counts()
    losses, ms, stats, by_kind = [], [], [], []
    for step in range(DEEPFM_SHARDED_STEPS):
        pol.STATS, pol.COLLECTIVES = {}, {}
        if step == DEEPFM_SHARDED_STEPS - 1:
            with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                                              else [])) as prof:
                (params, state, loss), t = _timed(lambda: fn(params, state, ids, labels), device)
            out["profile"] = step_profile(list(prof.events()))
        else:
            (params, state, loss), t = _timed(lambda: fn(params, state, ids, labels), device)
        stats.append(pol.STATS)
        by_kind.append(pol.COLLECTIVES)
        pol.STATS = pol.COLLECTIVES = None
        losses.append(float(loss))
        ms.append(t)
    out.update(train_launches=dict(k3.LAUNCHES), losses=losses, step_ms=ms, train_collectives=stats[0],
               train_by_kind=by_kind[0],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None)
    del params, state, ids, labels
    return out


PHASE_RUNNERS = {"lm": run_lm_serve, "lm_train": run_lm_train_cell, "recsys": run_deepfm_cells}


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def sharded_rank(rank: int, k: int, device: torch.device, phases: list) -> dict:
    """One rank of the 4-rank group: every phase's cells on its grid, bound
    to the rank's groups, run as `run_lm_serve` / `run_lm_train_cell` /
    `run_deepfm_cells` run them unsharded."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import Grid

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"_started_at": time.time()}
    for phase in phases:
        grid = Grid(("data", "model"), phase["grid"])
        cells = {role: c.bind() for role, c in phase_cells(phase, grid).items()}
        policy = next(iter(cells.values())).policy
        dist.barrier()
        at_start = dict(allocated_gb=torch.cuda.memory_allocated() / 1e9,
                        reserved_gb=torch.cuda.memory_reserved() / 1e9) if device.type == "cuda" else {}
        t0 = time.perf_counter()
        if phase["family"] == "lm":
            res = run_lm_serve(cells, phase, device, policy)
        else:
            res = PHASE_RUNNERS[phase["family"]](cells, device, policy)
        res.update(seconds=time.perf_counter() - t0, coords=cells[next(iter(cells))].coords, memory_at_start=at_start)
        if rank != 0:      # the gathered logits and scores are the same on every rank of a data slice
            for key in ("prefill_logits", "decode_logits", "retrieval_scores", "experts_per_layer", "decode_experts",
                        "moe_layer_out"):
                res.pop(key, None)
        if policy.model_index != 0:
            for key in ("serve_logits", "bulk_logits"):
                res.pop(key, None)
        if policy.data_index != 0:
            res.pop("grads", None)
        out[phase["name"]] = res
        del cells
        _free(device)
    out["_finished_at"] = time.time()
    return out


def sharded_references(device: torch.device) -> dict:
    """Each phase's unsharded counterpart, alone on the card (a 1 × 1 grid:
    the same cells, the same drawn weights); keeps on the host what the
    checks need and frees the card after each."""
    from repro_torch.launch.mesh import Grid

    refs = {}
    one = Grid(("data", "model"), (1, 1))
    for phase in sharded_phases():
        t0 = time.perf_counter()
        cells = phase_cells(phase, one)
        if phase["family"] == "lm":
            refs[phase["name"]] = run_lm_serve(cells, phase, device)
        else:
            refs[phase["name"]] = PHASE_RUNNERS[phase["family"]](cells, device)
        refs[phase["name"]]["seconds"] = time.perf_counter() - t0
        del cells
        _free(device)
    return refs


def _phase_times(results: list, key: str) -> list:
    return [r[key] for r in results]


def _collective_share(stats: dict, step_ms: float) -> dict:
    return dict(count=stats.get("count", 0), bytes=stats.get("bytes", 0), ms=stats.get("seconds", 0.0) * 1e3,
                share_of_step=stats.get("seconds", 0.0) * 1e3 / step_ms if step_ms else None)


def _card_idle(profiles: list) -> dict:
    """The card's idle share over one step, from every rank's own profile of
    that step (the ranks run the step at once, meeting in every
    collective): at least 1 − Σ the ranks' kernel-busy ms / the mean
    window. A lower bound: the four contexts time-slice the SMs, and a
    kernel's span includes the slices it waited, so the sum over-counts
    (it exceeds the window when kernels are long). The staging copies run
    on the copy engines and are reported apart."""
    busy = [p["kernel_busy_ms"] for p in profiles]
    window = [p["window_ms_per_step"] for p in profiles]
    return dict(card_idle_share_at_least=max(0.0, 1.0 - sum(busy) / statistics.mean(window)),
                kernel_busy_ms_per_rank=busy,
                copy_ms_per_rank=[p["copy_ms"] for p in profiles], window_ms_per_rank=window,
                top_kernels_rank0=profiles[0]["top_kernels"])


def capacity_drops(experts: np.ndarray, n_experts: int, capacity: int) -> int:
    """The (token, expert) pairs the reference's capacity rule drops for
    one group's (T, K) expert ids: each expert keeps its first ``capacity``."""
    return int(np.maximum(np.bincount(experts.reshape(-1), minlength=n_experts) - capacity, 0).sum())


def _logits_hold(got: np.ndarray, want: np.ndarray, rows=None) -> dict:
    """The logits within SHARDED_LOGIT_RTOL of max |logit| (on the rows
    ``rows`` marks, when given) and the same argmax up to ties within it."""
    g, w = torch.from_numpy(got.reshape(-1, got.shape[-1])), torch.from_numpy(want.reshape(-1, want.shape[-1]))
    keep = torch.ones(g.shape[0], dtype=torch.bool) if rows is None else torch.from_numpy(np.asarray(rows).reshape(-1))
    err, scale = max_err(g[keep], w[keep]) if bool(keep.any()) else (0.0, float(w.abs().max()))
    agree, raw, tied = argmax_agreement(g, w, SHARDED_LOGIT_RTOL)
    return dict(max_abs_err=err, max_abs_logit=scale, rtol=SHARDED_LOGIT_RTOL, argmax_agreement=agree,
                raw_argmax_equal=raw, tied_rows=tied, rows_held=int(keep.sum()), rows=int(keep.numel()),
                max_abs_err_all_rows=max_err(g, w)[0],
                ok=err <= SHARDED_LOGIT_RTOL * scale and agree == 1.0
                and bool(np.isfinite(got).all()) and got.shape == want.shape)


def _grad_hold(results: list, ref: dict, phase: dict, cells: dict, grid) -> dict:
    """Each rank's gradient shard against the same block of the unsharded
    gradient, relative to the whole leaf's largest entry."""
    from repro_torch.launch.shardings import shard_slices

    specs = named_leaves(next(iter(cells.values())).param_specs)
    worst, scales = {}, {}
    for r, res in enumerate(results):
        if "grads" not in res:
            continue
        for name, got in res["grads"].items():
            # torch on the host's threads, each leaf's scale once: lm_tp_train's gradient is 9.3 GB.
            want = ref["grads"][name]
            if name not in scales:
                scales[name] = float(torch.linalg.vector_norm(want, float("inf")))
            block = want[shard_slices(tuple(want.shape), specs[name], grid.coords(r))]
            scale = scales[name]
            rel = (float(torch.linalg.vector_norm(got - block, float("inf"))) / scale if scale
                   else float(torch.linalg.vector_norm(got, float("inf"))))
            worst[name] = max(worst.get(name, 0.0), rel)
    return worst


def check_sharded_kernels(device: torch.device) -> tuple[dict, dict]:
    """K4 (fp32 and bf16) and K3 against their plain versions at the shapes
    the group's ranks give them (and the dry run's group, t2-b's granite-34b
    micro-batch in the hillclimb's cells), with times, the plain version's,
    SDPA's and the bound beside (the parent alone on the card)."""
    from repro_torch.configs.gemma3_12b import FULL as gemma
    from repro_torch.configs.granite_34b import FULL as granite
    from repro_torch.configs.moonshot_v1_16b_a3b import FULL as moonshot
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import fm_interaction as k3

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rows, cases = {}, []
    glob = global_window()
    shapes = [("lm_tp", "k4_flash_attention_bf16", gemma.n_heads // 4, gemma.n_kv_heads // 4, SHARDED_SEQ,
               gemma.attn.head_dim, ((("local", gemma.window), ("global", glob))), torch.bfloat16),
              ("moe_ep", "k4_flash_attention_bf16", moonshot.n_heads // 4, moonshot.n_kv_heads // 4, SHARDED_SEQ,
               moonshot.attn.head_dim, (("global", glob),), torch.bfloat16),
              ("lm_tp_train", "k4_flash_attention", LM_TRAIN_BATCH * gemma.n_heads // 4,
               LM_TRAIN_BATCH * gemma.n_kv_heads // 4, LM_TRAIN_SEQ, gemma.attn.head_dim,
               (("local", gemma.window), ("global", glob)), torch.float32),
              ("hillclimb", "k4_flash_attention_bf16", granite.n_heads // 4, granite.n_kv_heads, HILL_GRANITE_SEQ,
               granite.attn.head_dim, (("global", glob),), torch.bfloat16)]
    with torch.inference_mode():
        for phase, name, h, hk, S, d, windows, dtype in shapes:
            q, k, v = (torch.randn((n, S, d), generator=gen, device=device).to(dtype) for n in (h, hk, hk))
            for tag, window in windows:
                out, ref = k4.flash_attention(q, k, v, window=window), k4.flash_attention_plain(q, k, v, window=window)
                err, scale = max_err(out.float(), ref.float())
                case = dict(kernel=name, phase=phase, case=f"{h}/{hk} heads × {S} × {d}, {tag}", max_abs_err=err,
                            max_abs_ref=scale)
                if dtype == torch.float32:
                    case.update(rtol=KERNEL_RTOL, ok=err <= KERNEL_RTOL * scale)
                else:
                    be = float((out == ref).float().mean())
                    case.update(rtol=K1_BF16_STEP, bit_equal=be,
                                ok=err <= K1_BF16_STEP * scale and be >= K1_BF16_BIT_EQUAL)
                cases.append(case)
                lib, lib_err = sdpa_ms(q, k, v, window)
                rows[f"{phase}_{tag}"] = dict(kernel=name, heads=[h, hk], S=S, d=d, window=window,
                                              ms=cuda_ms(lambda: k4.flash_attention(q, k, v, window=window)),
                                              plain_ms=cuda_ms(lambda: k4.flash_attention_plain(q, k, v, window=window),
                                                               reps=5),
                                              library_ms=lib, library_max_abs_err=lib_err,
                                              bound=list(k4_bound(h, hk, S, d, window, 2 if dtype != torch.float32
                                                                  else 4)))
                del out, ref
            del q, k, v
        F, D = 39, 10
        for tag, batch in (("serve_p99", 256), ("train_batch", 32_768), ("serve_bulk", 131_072)):
            emb = torch.randn((batch, F, D), generator=gen, device=device)
            out, ref = k3.fm_interaction(emb), k3.fm_interaction_plain(emb)
            err, scale = max_err(out, ref)
            cases.append(dict(kernel="k3_fm_interaction", phase="deepfm_sharded", case=f"{tag} a rank ({batch} × "
                              f"{F} × {D})", max_abs_err=err, max_abs_ref=scale, rtol=KERNEL_RTOL,
                              ok=err <= KERNEL_RTOL * scale))
            rows[f"deepfm_sharded_{tag}"] = dict(
                kernel="k3_fm_interaction", batch=batch, ms=device_ms(lambda: k3.fm_interaction(emb)),
                plain_ms=device_ms(lambda: k3.fm_interaction_plain(emb)), library_ms=None,
                bound=list(bound(4.0 * (batch * F * D + batch), 3.0 * batch * F * D + 3.0 * batch * D)))
            del emb, out, ref
    _free(device)
    ok = all(c["ok"] for c in cases)
    emit("sharded_kernels", ok=ok, cases=cases, times=rows,
         timing="K4: CUDA-event medians of 10 (plain, SDPA: 5) after 2 warm-ups; K3: device_ms; at one rank's "
                "shapes, the parent alone on the card")
    require(ok, "sharded_kernels", "a kernel disagrees with its plain version at a rank's shapes")
    worst = {}
    for c in cases:
        worst[c["kernel"]] = max(worst.get(c["kernel"], 0.0), c["max_abs_err"])
    return worst, rows


def run_sharded(device: torch.device, beside=None) -> dict:
    """The five phases of the sharded LM and DeepFM: every unsharded
    counterpart alone first (host copies of what the checks need), the
    kernels at a rank's shapes, then one group of SHARDED_K ranks sharing
    the card (gloo) running every phase's cells; one line per phase.
    Returns each phase's kernel launches summed over the ranks' counted
    runs, and the kernels' worst errors and timing rows; ``beside`` (a
    call that starts host work) is called just before the group starts,
    and what it returns comes back under ``beside``."""
    from repro_torch.launch.mesh import Grid, GroupSpec, run_group

    t0 = time.perf_counter()
    refs = sharded_references(device)
    worst, rows = check_sharded_kernels(device)
    spec = GroupSpec(k=SHARDED_K, backend="gloo", devices=(str(device) if device.type == "cpu" else "cuda:0",),
                     timeout_s=SHARDED_TIMEOUT_S)
    parent = dict(allocated_gb=torch.cuda.memory_allocated() / 1e9,
                  reserved_gb=torch.cuda.memory_reserved() / 1e9) if device.type == "cuda" else {}
    print(f"sharded group: {spec.describe()}; the parent holds {parent}", flush=True)
    t1, w1 = time.perf_counter(), time.time()
    # Four caching allocators share the card: segments that grow in place leave less of it stranded.
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    started = beside() if beside is not None else None
    try:
        results = run_group(spec, sharded_rank, [sharded_phases()] * SHARDED_K)
    finally:
        if alloc_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    group_s = time.perf_counter() - t1
    group_times = dict(seconds=group_s, start_up_s=max(r.pop("_started_at") for r in results) - w1,
                       results_and_exit_s=time.time() - min(r.pop("_finished_at") for r in results),
                       per_phase_rank0={name: r["seconds"] for name, r in results[0].items()})
    print(json.dumps({"sharded_group": group_times}), flush=True)
    launches = {}
    for phase in sharded_phases():
        name = phase["name"]
        grid = Grid(("data", "model"), phase["grid"])
        res, ref = [r[name] for r in results], refs[name]
        cells = phase_cells(phase, grid)
        line, checks = dict(config=phase["arch"], grid=dict(zip(("data", "model"), phase["grid"])),
                            dtype=phase["dtype"], reduced=phase_reduced(phase),
                            memory_at_start_per_rank=_phase_times(res, "memory_at_start"), parent_memory=parent,
                            peak_memory_gb_per_rank=_phase_times(res, "peak_memory_gb"),
                            unsharded_peak_memory_gb=ref["peak_memory_gb"], seconds_per_rank=_phase_times(res, "seconds"),
                            unsharded_seconds=ref["seconds"]), {}
        if phase["family"] == "lm":
            dec = cells["decode"]
            line.update(parameters_gb_per_rank=_phase_times(res, "parameters_gb"),
                        unsharded_parameters_gb=ref["parameters_gb"], cache_spec=list(dec.policy.cache),
                        positions=res[0]["positions"], decode_ms_per_rank=_phase_times(res, "decode_ms"),
                        decode_ms_median_per_rank=[statistics.median(r["decode_ms"]) for r in res],
                        unsharded_decode_ms_median=statistics.median(ref["decode_ms"]))
            moe_rows = None
            if dec.cfg.is_moe:
                # The expert-parallel function itself is held layer by layer (moe_layer_hold). End to end, a
                # row's logits are held where its routing matched the unsharded run's in every layer of every
                # step so far (a flipped top-k choice is another function of the row, not an error).
                hold, moe_checks = moe_layer_hold(res, ref)
                line.update(hold)
                checks.update(moe_checks)
                same = np.sort(res[0]["decode_experts"], -1) == np.sort(ref["decode_experts"], -1)
                moe_rows = np.logical_and.accumulate(same.all(axis=(1, 3)), axis=0)      # (steps, B)
                line["decode_rows_routed_alike"] = moe_rows.tolist()
            line["decode_vs_unsharded"] = _logits_hold(res[0]["decode_logits"], ref["decode_logits"], moe_rows)
            checks["decode_vs_unsharded"] = line["decode_vs_unsharded"]["ok"]
            checks["decode_no_k4"] = all(sum(r["decode_launches"].values()) == 0 for r in res)
            step = statistics.median(res[0]["decode_ms"])
            line["decode_collectives_per_step_rank0"] = _collective_share(res[0]["decode_collectives"], step)
            line["decode_profile"] = _card_idle(_phase_times(res, "decode_profile"))
            line["unsharded_decode_profile"] = ref["decode_profile"]
            if phase["prefill"]:
                cfg = cells["prefill"].cfg
                n_global = int((cfg.window_sizes() == global_window()).sum())
                per = {"k4_flash_attention": 0, "k4_flash_attention_bf16": SHARDED_PREFILLS * cfg.n_layers}
                wins = {str(w): SHARDED_PREFILLS * n for w, n in
                        ((cfg.window, cfg.n_layers - n_global), (global_window(), n_global)) if n}
                line.update(prefill_ms_per_rank=_phase_times(res, "prefill_ms"), unsharded_prefill_ms=ref["prefill_ms"],
                            prefill_launches_per_rank=_phase_times(res, "prefill_launches"), expected_launches=per,
                            prefill_windows_per_rank=_phase_times(res, "prefill_windows"), expected_windows=wins,
                            prefill_collectives_rank0=_collective_share(res[0]["prefill_collectives"],
                                                                        res[0]["prefill_ms"][-1]))
                line["prefill_vs_unsharded"] = _logits_hold(res[0]["prefill_logits"], ref["prefill_logits"])
                checks["prefill_vs_unsharded"] = line["prefill_vs_unsharded"]["ok"]
                checks["prefill_launches"] = all(r["prefill_launches"] == per for r in res)
                checks["prefill_windows"] = all(r["prefill_windows"] == wins for r in res)
                launches[name] = {k: sum(r["prefill_launches"][k] for r in res) for k in per}
                if cfg.is_moe:
                    moe_cfg = cfg.moe_cfg()
                    cap = moe_cfg.capacity(SHARDED_SEQ)
                    rule = lambda experts: [capacity_drops(e, moe_cfg.num_experts, cap) for e in experts]
                    alike = [float((np.sort(a, -1) == np.sort(b, -1)).all(-1).mean())
                             for a, b in zip(res[0]["experts_per_layer"], ref["experts_per_layer"])]
                    first = next((i for i, a in enumerate(alike) if a < 1.0), cfg.n_layers)
                    line.update(dropped_per_layer=res[0]["dropped_per_layer"],
                                unsharded_dropped_per_layer=ref["dropped_per_layer"],
                                routing_alike_share_per_layer=alike, first_layer_routed_differently=first,
                                routing_margin_min=min(res[0]["margin_per_layer"]),
                                unsharded_routing_margin_min=min(ref["margin_per_layer"]), capacity=cap)
                    # Exact where the routing agrees; where a tie flipped, each run's drops are the
                    # reference's capacity rule applied to its own routing.
                    checks["dropped_per_layer"] = (
                        all(r["dropped_per_layer"] == res[0]["dropped_per_layer"] for r in res)
                        and res[0]["dropped_per_layer"][:first] == ref["dropped_per_layer"][:first]
                        and res[0]["dropped_per_layer"] == rule(res[0]["experts_per_layer"])
                        and ref["dropped_per_layer"] == rule(ref["experts_per_layer"]))
            else:
                launches[name] = {"k4_flash_attention": 0, "k4_flash_attention_bf16": 0}
        elif phase["family"] == "lm_train":
            cfg = cells["train"].cfg
            grad = _grad_hold(res, ref, phase, cells, grid)
            n_global = int((cfg.window_sizes() == global_window()).sum())
            per = {"k4_flash_attention": SHARDED_TRAIN_STEPS * cfg.n_layers, "k4_flash_attention_bf16": 0}
            line.update(gradient_rel_err_by_leaf=grad, gradient_rtol=SHARDED_GRAD_RTOL, loss0=res[0]["loss0"],
                        unsharded_loss0=ref["loss0"], losses=res[0]["losses"], unsharded_losses=ref["losses"],
                        step_ms_per_rank=_phase_times(res, "step_ms"), unsharded_step_ms=ref["step_ms"],
                        launches_per_rank=_phase_times(res, "launches"), expected_launches=per,
                        windows_rank0=res[0]["windows"],
                        collectives_per_step_rank0=_collective_share(res[0]["collectives"], res[0]["step_ms"][0]),
                        profile=_card_idle(_phase_times(res, "profile")), unsharded_profile=ref["profile"])
            checks.update(gradient_vs_unsharded=max(grad.values()) <= SHARDED_GRAD_RTOL and
                          len(grad) == len(ref["grads"]),
                          loss0_vs_unsharded=abs(res[0]["loss0"] - ref["loss0"]) <= SHARDED_LOSS_RTOL * abs(ref["loss0"]),
                          losses_vs_unsharded=all(len(r["losses"]) == len(ref["losses"]) and all(
                              abs(a - b) <= SHARDED_LOSS_RTOL * abs(b) for a, b in zip(r["losses"], ref["losses"]))
                              for r in res),
                          finite_losses=all(np.isfinite(r["losses"]).all() for r in res),
                          loss_falls=res[0]["losses"][-1] < res[0]["losses"][0],
                          launches=all(r["launches"] == per for r in res),
                          windows=res[0]["windows"] == {str(cfg.window): SHARDED_TRAIN_STEPS * (cfg.n_layers - n_global),
                                                        str(global_window()): SHARDED_TRAIN_STEPS * n_global})
            launches[name] = {k: sum(r["launches"][k] for r in res) for k in per}
        else:
            n_model = grid.shape["model"]
            data_ranks = range(0, grid.size, n_model)
            serve = np.concatenate([res[d]["serve_logits"] for d in data_ranks])
            bulk = np.concatenate([res[d]["bulk_logits"] for d in data_ranks])
            holds = {}
            for key, got, want in (("serve", serve, ref["serve_logits"]), ("bulk", bulk, ref["bulk_logits"]),
                                   ("retrieval", res[0]["retrieval_scores"], ref["retrieval_scores"])):
                err, scale = max_err(torch.from_numpy(got), torch.from_numpy(want))
                holds[key] = dict(max_abs_err=err, max_abs_ref=scale, rtol=DEEPFM_LOGIT_RTOL,
                                  ok=got.shape == want.shape and err <= DEEPFM_LOGIT_RTOL * scale)
                checks[f"{key}_vs_unsharded"] = holds[key]["ok"]
            grad = _grad_hold(res, ref, phase, cells, grid)
            per_serve = {"k3_fm_interaction": DEEPFM_REQUESTS + 2, "k3_fm_interaction_bf16": 0}
            per_train = {"k3_fm_interaction": DEEPFM_SHARDED_STEPS, "k3_fm_interaction_bf16": 0}
            line.update(holds=holds, gradient_rel_err_by_leaf=grad, gradient_rtol=SHARDED_GRAD_RTOL,
                        loss0=res[0]["loss0"], unsharded_loss0=ref["loss0"], losses=res[0]["losses"],
                        unsharded_losses=ref["losses"], serve_ms_per_rank=_phase_times(res, "serve_ms"),
                        unsharded_serve_ms=ref["serve_ms"], bulk_ms_per_rank=_phase_times(res, "bulk_ms"),
                        unsharded_bulk_ms=ref["bulk_ms"], retrieval_ms_per_rank=_phase_times(res, "retrieval_ms"),
                        unsharded_retrieval_ms=ref["retrieval_ms"], step_ms_per_rank=_phase_times(res, "step_ms"),
                        unsharded_step_ms=ref["step_ms"],
                        launches_per_rank=dict(serve=_phase_times(res, "serve_launches"),
                                               train=_phase_times(res, "train_launches")),
                        collectives_rank0=dict(
                            serve=_collective_share(res[0]["serve_collectives"], res[0]["serve_ms"][-1]),
                            bulk=_collective_share(res[0]["bulk_collectives"], res[0]["bulk_ms"]),
                            retrieval=_collective_share(res[0]["retrieval_collectives"], res[0]["retrieval_ms"]),
                            train_step=_collective_share(res[0]["train_collectives"], res[0]["step_ms"][0])),
                        profile=_card_idle(_phase_times(res, "profile")), unsharded_profile=ref["profile"])
            checks.update(gradient_vs_unsharded=max(grad.values()) <= SHARDED_GRAD_RTOL and
                          len(grad) == len(ref["grads"]),
                          loss0_vs_unsharded=abs(res[0]["loss0"] - ref["loss0"]) <= SHARDED_LOSS_RTOL * abs(ref["loss0"]),
                          losses_vs_unsharded=all(len(r["losses"]) == len(ref["losses"]) and all(
                              abs(a - b) <= SHARDED_LOSS_RTOL * abs(b) for a, b in zip(r["losses"], ref["losses"]))
                              for r in res),
                          finite_losses=all(np.isfinite(r["losses"]).all() for r in res),
                          loss_falls=res[0]["losses"][-1] < res[0]["losses"][0],
                          launches=all(r["serve_launches"] == per_serve and r["train_launches"] == per_train
                                       for r in res))
            launches[name] = {k: sum(r["serve_launches"][k] + r["train_launches"][k] for r in res) for k in per_serve}
        ok = all(checks.values())
        emit(name, ok=ok, checks=checks, **line,
             timing="host clock around each call, ended by a synchronisation (the collectives are synchronous); "
                    f"{SHARDED_K} ranks share one card through gloo, so these are not multi-card times; "
                    "collectives: count, bytes a rank puts on the wire, host ms (staging through the host "
                    "included) and their share of the step; card_idle_share_at_least: 1 − Σ the ranks' own "
                    "kernel-busy ms / the mean window of one profiled step (a decode or training step)")
        require(ok, name, f"checks {checks}")
    emit("sharded", ok=True, group=spec.describe(), group_seconds=group_times, seconds=time.perf_counter() - t0,
         phases=[p["name"] for p in sharded_phases()])
    measured = {"lm_tp/prefill": (results[0]["lm_tp"]["prefill_collectives"], results[0]["lm_tp"]["prefill_by_kind"])}
    for role in ("serve", "bulk", "retrieval", "train"):
        res0 = results[0]["deepfm_sharded"]
        measured[f"deepfm_sharded/{role}"] = (res0[f"{role}_collectives"], res0[f"{role}_by_kind"])
    return dict(launches=launches, worst=worst, rows=rows, measured=measured, beside=started)


def dryrun_jobs() -> list:
    """(b): the GNN cells one 4-rank group runs for a train step each, at
    full_graph_sm (Cora's size; coin_gcn's ``cora`` is the same 2,708 ×
    10,556 graph and widths), full width; ``keep`` ones return their loss,
    updated parameters and gradient for (c)."""
    from repro_torch.launch.dryrun import StepJob

    flat, pods = dict(axes=("data", "model"), sizes=(1, DRYRUN_K)), dict(axes=("pod", "data", "model"), sizes=(2, 1, 2))
    shape = "full_graph_sm"
    return [
        StepJob("pna", shape, **flat), StepJob("pna", shape, **flat, payload="bf16"),
        StepJob("pna", shape, **flat, payload="int8"), StepJob("pna", shape, **pods),
        StepJob("pna", shape, **flat, comm="broadcast"),
        StepJob("egnn", shape, **flat), StepJob("graphcast", shape, **flat),
        StepJob("coin_gcn", "cora", **flat, optimized=True, keep=False),
        # (c)'s holds: coin_gcn with its per-rank 4-bit calibration off; PNA's and EquiformerV2's gradients in
        # float64 (PNA's fp32 std is ill-conditioned; EquiformerV2's fp32 gradient overflows in the halo layout, as
        # the reference's does: PERF.md §6).
        StepJob("coin_gcn", "cora", **flat, optimized=True, quant_off=True),
        StepJob("pna", shape, **flat, dtype="float64"), StepJob("pna", shape, **pods, dtype="float64"),
        StepJob("pna", shape, **flat, comm="broadcast", dtype="float64"),
        StepJob("equiformer-v2", shape, **flat, dtype="float64"), StepJob("equiformer-v2", shape, **pods, dtype="float64"),
    ]


def dryrun_unsharded(job):
    """The same cell at k = 1 (a 1 × 1 grid: the reference's k = 1 cell)."""
    return dataclasses.replace(job, axes=("data", "model"), sizes=(1, 1))


DRYRUN_HOST_PARTS = 2            # (a): the sweep's records split over this many host subprocesses


def dryrun_host(out_path: str, part: int, parts: int) -> None:
    """The dry run's host half (subprocesses that never touch the card, so
    their fake process groups never meet the card's groups): (a) every
    ``parts``-th record of the sweep on 16 × 16 and 2 × 16 × 16, from
    ``part`` on; part 0 also (b) the meta counts of `dryrun_jobs` and (d)
    the meta counts of the lm_tp prefill and the deepfm_sharded cells on
    their grids. Writes one JSON file."""
    from repro_torch.launch.dryrun import count_step, meta_steps, run_cell
    from repro_torch.launch.mesh import Grid, fake_group

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    sweep = []
    records = [(arch, shape, kw, multi) for arch, shape, kw in DRYRUN_SWEEP for multi in (False, True)]
    for arch, shape, kw, multi in records[part::parts]:
        rec = run_cell(arch, shape, multi, verbose=False, **kw)
        sweep.append({k: v for k, v in rec.items() if k != "trace"} | (
            {"trace": rec["trace"]} if rec["status"] == "FAIL" else {}))
    out = dict(sweep=sweep, sweep_seconds=time.perf_counter() - t0)
    if part == 0:
        t1 = time.perf_counter()
        out.update(meta=meta_steps(dryrun_jobs()), meta_seconds=time.perf_counter() - t1)
        t2 = time.perf_counter()
        sharded = {}
        for phase in sharded_phases():
            if phase["name"] not in ("lm_tp", "deepfm_sharded"):
                continue
            grid = Grid(("data", "model"), phase["grid"])
            with fake_group(grid, 0):
                cells = {role: c.bind() for role, c in phase_cells(phase, grid).items()}
                roles = ("prefill",) if phase["family"] == "lm" else ("serve", "bulk", "retrieval", "train")
                for role in roles:
                    sharded[f"{phase['name']}/{role}"] = count_step(cells[role].fn, cells[role].abstract_inputs())[
                        "collectives"]
        out.update(sharded=sharded, sharded_seconds=time.perf_counter() - t2)
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)


def start_host(flag: str, parts: int) -> list:
    """Start a host half (``flag`` names it in `HOST_MODES`) in ``parts``
    subprocesses with no card visible, so their fake process groups never
    meet the card's groups; they run on the host beside a rank group or
    a phase of the parent. What a part prints goes to a temporary file (a
    pipe, read only at the end, could fill and stall it)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    procs = []
    for part in range(parts):
        out = tempfile.NamedTemporaryFile(prefix=f"chip_smoke{flag.replace('-', '_')}_", suffix=".json",
                                          delete=False).name
        said = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), flag, out, str(part), str(parts)],
                                env=env, stdout=said, stderr=subprocess.STDOUT, text=True)
        atexit.register(lambda proc=proc: proc.poll() is None and proc.kill())   # a failed phase leaves nothing
        procs.append((proc, out, said, time.perf_counter()))
    return procs


def wait_host(procs: list, line: str) -> list[dict]:
    """Each host part's JSON, in the order of the parts, with ``seconds``
    from its start until it was seen to end; ``line`` fails if a part
    exited with another code than 0."""
    parts = []
    for proc, out_path, said, t0 in procs:
        proc.wait(timeout=DRYRUN_TIMEOUT_S)
        said.seek(0)
        text = said.read()
        said.close()
        require(proc.returncode == 0, line, f"a host part exited {proc.returncode}: {text[-3000:]}")
        with open(out_path) as f:
            parts.append(json.load(f) | {"seconds": time.perf_counter() - t0})
        os.unlink(out_path)
    return parts


def _leaf_map(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _leaf_map(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in _leaf_map(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _hold(got: dict, want: dict, dtype: str) -> dict:
    """(c): the loss, each gradient leaf and each held parameter leaf of a
    4-rank step against the k = 1 step (``dtype``: the cell's). A leaf whose
    gradient the model cancels (EQ_CANCELLED: rounding alone) is held
    against the largest leaf's max, and its parameters, stepped by the sign
    of that rounding, are left unheld. A leaf whose gradient is not finite in
    either run is counted (``nonfinite_grad_leaves``), its parameters left
    unheld, and the hold fails."""
    g_got, g_want = _leaf_map(got["grads"]), _leaf_map(want["grads"])
    p_got, p_want = _leaf_map(got["params"]), _leaf_map(want["params"])
    nonfinite = sorted(k for k in g_want if not (np.isfinite(g_got[k]).all() and np.isfinite(g_want[k]).all()))
    if nonfinite:                       # reported, and never held: the errors below cover the finite leaves
        g_got, g_want = ({k: v for k, v in g.items() if k not in nonfinite} for g in (g_got, g_want))
    top = max(float(np.abs(v).max()) for v in g_want.values())
    cancelled = {k for k in g_want if k.endswith(EQ_CANCELLED)}
    grad = max(float(np.abs(g_got[k] - v).max()) / (top if k in cancelled else max(float(np.abs(v).max()), 1e-30))
               for k, v in g_want.items())
    param, unheld, total = 0.0, 0, 0
    for k, v in p_want.items():
        if k in nonfinite:
            unheld, total = unheld + int(v.size), total + int(v.size)
            continue
        sel = np.abs(g_want[k]) >= DRYRUN_SIGN_FLOOR[dtype] * float(np.abs(g_want[k]).max())
        if k in cancelled:
            sel = np.zeros_like(sel)
        diff = np.abs(p_got[k] - v)
        param = max(param, (float(diff[sel].max()) if sel.any() else 0.0) / max(float(np.abs(v).max()), 1e-30))
        unheld, total = unheld + int((~sel).sum()), total + int(v.size)
    loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    return dict(loss=got["loss"], k1_loss=want["loss"], loss_rel_err=loss, grad_rel_err=grad, param_rel_err=param,
                params_unheld=unheld, params=total, nonfinite_grad_leaves=len(nonfinite),
                nonfinite_grad_leaves_first=nonfinite[:4],
                ok=not nonfinite and loss <= DRYRUN_LOSS_RTOL and grad <= DRYRUN_HOLD_RTOL and param <= DRYRUN_HOLD_RTOL)


# ------------------------------------------------------------------ the hillclimb
HILL_GRANITE_LAYERS = 2          # t2-b: granite-34b's depth cut 88 → 2 (4 ranks on one card, gloo through the host)
HILL_GRANITE_BATCH = 8           # t2-b: train_4k's 256 × 4,096 → 8 × 4,096: 8 micro-batches of 1 row (16 rows:
                                 #       the remat cell's vocab-parallel cross entropy took ≈ 17 GB a rank)
HILL_GRANITE_SEQ = 4096          # t2-b: train_4k's sequence, whole
HILL_GEMMA_LAYERS = 12           # t4: gemma3-12b's depth cut 48 → 12 (two groups of 5 local + 1 global)
HILL_GEMMA_CACHE = 32_768        # t4: long_500k's 524,288-slot cache → 32,768, split by sequence (8,192 a rank)
HILL_POS = 8192 + 511            # t4: past rank 0's slice; the local window [7,680, 8,703] crosses into it
HILL_ACC_LOSS_RTOL = 1e-2        # (b): t2-b's loss vs one step of the remat cell on the same rows, relative
HILL_ACC_GRAD_RTOL = 5e-2        # (b): each gradient leaf, · its max (the parity contract's bf16 rule)
HILL_DECODE_RTOL = 5e-2          # (c): t4-a / t4-b logits vs the uniform decode's, · max |logit|
HILL_PNA_LOSS_RTOL = 1e-2        # (d): t3-b / t3-c losses vs the fp32 cell's, relative
HILL_PNA_F64_RTOL = 1e-4         # (d): float64 cell vs its k blocks in one process: loss relative, gradient · leaf max
HILL_ROLES = ("pna_fp32", "t3b", "t3c", "pna_float64", "t4_uniform", "t4a", "t4b", "t2b", "t2a")
HILL_HOST_PARTS = (("target2_granite",), ("target1_moe", "target3_pna", "target4_gemma_cache"))
HILL_REDUCED = {
    "t2-b": {"n_layers": f"88 → {HILL_GRANITE_LAYERS} (4 ranks share one card through gloo); widths whole",
             "batch": f"train_4k's 256 × 4,096 → {HILL_GRANITE_BATCH} × 4,096 ({HILL_GRANITE_BATCH // 8} row a "
                      "micro-batch; at 16 rows the remat cell's vocab-parallel cross entropy needs ≈ 17 GB a rank: "
                      "4 ranks overflow the card)"},
    "t3-b, t3-c": {"shape": "ogb_products → full_graph_sm (2,708 × 10,556, Cora's size: the ogb_products plan "
                            "alone takes minutes of host BFS); widths whole (1,433 → 4 × 75 → 7)"},
    "t4": {"n_layers": f"48 → {HILL_GEMMA_LAYERS} (two groups of 5 local + 1 global); widths whole",
           "cache": f"long_500k's 524,288 slots → {HILL_GEMMA_CACHE:,}, split by sequence over 4 ranks; B 1",
           "pos": f"{HILL_POS} (past rank 0's slice: the window crosses a slice edge)"},
}


def hill_cell(role: str, grid):
    """One hand-built (or baseline) cell of `repro_torch.launch.hillclimb`
    at the card's size on ``grid``: (the cell, the position a decode cell
    runs at, or None)."""
    from repro_torch.configs.registry import ShapeSpec, get_arch
    from repro_torch.launch import hillclimb as hc
    from repro_torch.launch.steps import _shape_halo_plan, build_cell

    if role.startswith(("pna", "t3")):
        spec = get_arch("pna")
        shape = spec.shapes["full_graph_sm"]
        plan = _shape_halo_plan(shape.n_nodes, shape.n_edges, grid.shape["model"])
        kw = {"t3b": dict(compute_dtype=torch.bfloat16), "t3c": dict(payload="bf16"),
              "pna_float64": dict(compute_dtype=torch.float64)}.get(role, {})
        return hc._pna_halo_cell(grid, plan, spec.make_config(shape), shape, **kw), None
    if role.startswith("t4"):
        spec = get_arch("gemma3-12b")
        cfg = dataclasses.replace(spec.make_config(), n_layers=HILL_GEMMA_LAYERS)
        spec = dataclasses.replace(spec, make_config=lambda shape=None, c=cfg: c)
        shape = ShapeSpec("long_500k", "decode", seq_len=HILL_GEMMA_CACHE, global_batch=1)
        if role == "t4_uniform":
            return build_cell(spec, shape, grid), HILL_POS
        return hc._gemma_twostack_cell(grid, spec, shape, ring=role == "t4b", pos=HILL_POS), None
    spec = get_arch("granite-34b")
    cfg = dataclasses.replace(spec.make_config(), n_layers=HILL_GRANITE_LAYERS, remat=True)
    spec = dataclasses.replace(spec, make_config=lambda shape=None, c=cfg: c)
    shape = ShapeSpec("train_4k", "train", seq_len=HILL_GRANITE_SEQ, global_batch=HILL_GRANITE_BATCH)
    base = build_cell(spec, shape, grid)
    return (hc._granite_accum_cell(base) if role == "t2b" else base), None


def _hill_args(cell, pos, seed: int, device, params=None) -> tuple:
    """The cell's seeded inputs on ``device`` (meta: `Cell.abstract_inputs`),
    a decode cell's position replaced by ``pos``."""
    args = cell.abstract_inputs() if device == "meta" else cell.make_inputs(seed, device, params)
    return args if pos is None else (*args[:3], pos)


def hill_rank(rank: int, k: int, device: torch.device) -> dict:
    """Every `HILL_ROLES` cell's step on this rank of 1 × k, each under
    `count_step` (FLOPs and collectives for (a)); the holds' numbers are
    made here (the granite gradients stay on the rank): (b) t2-b's loss and
    first AdamW moment per leaf against the remat cell's; (c) the two-stack
    logits against the uniform decode's (the rank's vocab shard, returned)
    and t4-b's written ring slots against the uniform cache at ``pos``;
    (d) the PNA losses and rank 0's float64 gradient; K1–K4 launches."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import Grid

    grid = Grid(("data", "model"), (1, k))
    reset_launch_counts()
    out, keep, params = {"launches_by_role": {}}, {}, None
    for role in HILL_ROLES:
        before = launch_counts()
        cell, pos = hill_cell(role, grid)
        cell = cell.bind()
        if role in ("t4a", "t4b") and params is not None:
            args = _hill_args(cell, pos, SEED, device, params)
        else:
            args = _hill_args(cell, pos, SEED, device)
        if role == "t4_uniform":
            params, keep["uniform_split"] = args[0], cell.policy.cache_split()[0]
        t0 = time.perf_counter()
        run = count_step(cell.fn, args)
        _sync(device)
        rec = dict(flops=run["flops"], collectives=run["collectives"], seconds=time.perf_counter() - t0)
        after = launch_counts()
        out["launches_by_role"][role] = {n: after[n] - before[n] for n in after if after[n] != before[n]}
        if cell.kind == "train_step":
            _, opt_state, loss = run["out"]
            rec["loss"] = float(loss)
            if role == "pna_float64" and rank == 0:
                rec["grads"] = _host_tree({k_: v / (1 - 0.9) for k_, v in named_leaves(opt_state["m"]).items()})
            if role in ("t2b", "t2a"):
                keep[role] = named_leaves(opt_state["m"])
        else:
            logits, cache = run["out"]
            rec["logits"] = logits.float().cpu()
            keep[role] = cache
        out[role] = rec
        del run, args, cell
        if role == "t4b":
            out.update(hill_decode_holds(keep, rank))
            keep.clear()
            params = None
        _free(device)
    a, b = keep["t2b"], keep["t2a"]
    out["accum_grad_rel_err"] = max(float((a[n].float() - b[n].float()).abs().max())
                                    / max(float(b[n].float().abs().max()), 1e-30) for n in b)
    out["accum_leaves"] = len(b)
    del keep
    _free(device)
    out["launches"] = launch_counts()
    return out


def hill_decode_holds(keep: dict, r: int) -> dict:
    """(c) on rank ``r``: t4-b's ring slot ``pos mod W`` of each local layer
    against the uniform cache's new k / v at ``pos`` (the rank's kv heads
    of a head split; under a sequence split, the rank that holds ``pos``):
    the first local layer, whose inputs are the same bits in both, bit for
    bit; every other within HILL_DECODE_RTOL of the layer's max."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch("gemma3-12b").make_config()
    period, W = cfg.global_every, cfg.window
    uni, ring = keep["t4_uniform"], keep["t4b"]
    if keep["uniform_split"] == "heads":                      # the rank's kv heads, every position
        hk = uni["k"].shape[3]
        at, heads = HILL_POS, slice(hk * r, hk * (r + 1))
    else:                                                    # by sequence: the rank whose slice holds pos
        s_loc = uni["k"].shape[2]
        if HILL_POS // s_loc != r:
            return {"ring_slot": None}
        at, heads = HILL_POS - r * s_loc, slice(None)
    slot = {"exact_first_layer": True, "rel_err_other_layers": 0.0}
    for name in ("k", "v"):
        for g in range(HILL_GEMMA_LAYERS // period):
            for j in range(period - 1):
                want = uni[name][g * period + j][:, at].float()
                got = ring["r" + name][g, j][:, HILL_POS % W, heads].float()
                if g == j == 0:
                    slot["exact_first_layer"] &= bool(torch.equal(got, want))
                else:
                    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
                    slot["rel_err_other_layers"] = max(slot["rel_err_other_layers"], err)
    return {"ring_slot": slot}


def dryrun_rank(rank: int, k: int, device: torch.device, jobs: list) -> dict:
    """The dry run's 4-rank group: `repro_torch.launch.dryrun.real_steps` of
    the GNN jobs, then the hillclimb's cells (`hill_rank`)."""
    from repro_torch.launch.dryrun import real_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    out = real_steps(rank, k, device, jobs)
    _free(device)
    out["hillclimb"] = hill_rank(rank, k, device)
    return out


def hill_meta(k: int) -> dict:
    """(a)'s meta side: each `HILL_ROLES` cell's FLOPs and collectives as
    every rank of 1 × k, on meta tensors in a fake group."""
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import Grid, fake_group

    grid, out = Grid(("data", "model"), (1, k)), {}
    for rank in range(k):
        with fake_group(grid, rank):
            for role in HILL_ROLES:
                cell, pos = hill_cell(role, grid)
                cell = cell.bind()
                run = count_step(cell.fn, _hill_args(cell, pos, SEED, "meta"))
                out[f"{role}/{rank}"] = dict(flops=run["flops"], collectives=run["collectives"])
                del run, cell
    return out


def hillclimb_host(out_path: str, part: int, parts: int) -> None:
    """The hillclimb's host records (a subprocess that never touches the
    card): `HILL_HOST_PARTS[part]`'s targets of
    `repro_torch.launch.hillclimb` on 16 × 16, t1, t2 and t4 at their
    production shapes, t3 at full_graph_sm, each target's records with a
    status, in a temporary working directory (t3 writes its plan there);
    the last part also `hill_meta`. Writes one JSON file."""
    import contextlib
    import io
    import traceback

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import hillclimb as hc

    torch.set_num_threads(1)
    out = {"targets": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hillclimb_") as tmp:
        os.chdir(tmp)
        for name in HILL_HOST_PARTS[part]:
            t0 = time.perf_counter()
            kw = {"shape": get_arch("pna").shapes["full_graph_sm"]} if name == "target3_pna" else {}
            try:
                with contextlib.redirect_stdout(io.StringIO()) as said:
                    recs = getattr(hc, name)(**kw)
                out["targets"][name] = dict(status="OK", records=recs, printed=said.getvalue()[-4000:])
            except Exception as e:  # noqa: BLE001 — recorded; the line fails on it
                out["targets"][name] = dict(status="FAIL", error=f"{type(e).__name__}: {e}",
                                            trace=traceback.format_exc()[-2000:])
            out["targets"][name]["seconds"] = time.perf_counter() - t0
        os.chdir(ROOT)
    if part == parts - 1:
        t0 = time.perf_counter()
        out["meta"] = hill_meta(DRYRUN_K)
        out["meta_seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)


def run_hillclimb_line(results: list, host: dict, device: torch.device, group_s: float) -> dict:
    """The ``hillclimb`` line from the dry run's group (each rank's
    `hill_rank`) and the host parts: (a) every cell's FLOPs and collectives
    by kind equal to the meta run's as the same rank; (b) t2-b against
    the remat cell; (c) the two-stack decodes against the uniform one, and
    the ring slots; (d) t3-b / t3-c losses against the fp32 cell's, and
    the float64 cell's loss and gradient against its k blocks in one
    process on the card (`repro_torch.launch.hillclimb.pna_halo_lockstep_loss`);
    (e) t3-c's halo all-gather result bytes half the fp32 cell's; and the
    host records, each target OK, t3-a above t3-baseline in collective
    bytes, t2-a below t2-baseline in peak bytes, t2-c equal to t2-a.
    Returns the group's K1–K4 launches of these cells."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import hillclimb as hc
    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.steps import _gnn_params, draw_tree
    from repro_torch.train.loop import value_and_grad

    hill = [r["hillclimb"] for r in results]
    k = len(hill)
    checks, line = {}, {}
    # (a)
    counts = {}
    for role in HILL_ROLES:
        same = [h[role]["flops"] == host["meta"][f"{role}/{r}"]["flops"]
                and h[role]["collectives"] == host["meta"][f"{role}/{r}"]["collectives"] for r, h in enumerate(hill)]
        checks[f"a_{role}"] = all(same)
        counts[role] = dict(flops_per_rank=[h[role]["flops"] for h in hill], equal_per_rank=same,
                            collectives_rank0={kind: v for kind, v in hill[0][role]["collectives"].items()
                                               if v["count"]},
                            seconds_per_rank=[round(h[role]["seconds"], 3) for h in hill])
    # (b)
    loss_b, loss_a = hill[0]["t2b"]["loss"], hill[0]["t2a"]["loss"]
    accum = dict(loss=loss_b, remat_loss=loss_a, loss_rel_err=abs(loss_b - loss_a) / abs(loss_a),
                 grad_rel_err_per_rank=[h["accum_grad_rel_err"] for h in hill], leaves=hill[0]["accum_leaves"],
                 loss_rtol=HILL_ACC_LOSS_RTOL, grad_rtol=HILL_ACC_GRAD_RTOL)
    checks["b_accum"] = (accum["loss_rel_err"] <= HILL_ACC_LOSS_RTOL
                         and max(accum["grad_rel_err_per_rank"]) <= HILL_ACC_GRAD_RTOL)
    # (c)
    whole = {role: torch.cat([h[role]["logits"] for h in hill], dim=-1) for role in ("t4_uniform", "t4a", "t4b")}
    decode = {}
    scale = float(whole["t4_uniform"].abs().max())
    for role in ("t4a", "t4b"):
        err = float((whole[role] - whole["t4_uniform"]).abs().max()) / scale
        agree = float((whole[role].argmax(-1) == whole["t4_uniform"].argmax(-1)).float().mean())
        decode[role] = dict(logits_rel_err=err, argmax_agreement=agree, rtol=HILL_DECODE_RTOL)
        checks[f"c_{role}"] = err <= HILL_DECODE_RTOL and agree == 1.0
    decode["t4b_ring_slot"] = [h["ring_slot"] for h in hill]          # None: the uniform cache's pos is elsewhere
    held = [s for s in decode["t4b_ring_slot"] if s is not None]
    checks["c_ring_slot"] = bool(held) and all(s["exact_first_layer"] and s["rel_err_other_layers"] <= HILL_DECODE_RTOL
                                               for s in held)
    # (d)
    fp32 = hill[0]["pna_fp32"]["loss"]
    pna = {role: dict(loss=hill[0][role]["loss"], rel_err=abs(hill[0][role]["loss"] - fp32) / abs(fp32))
           for role in ("t3b", "t3c")}
    for role in ("t3b", "t3c"):
        checks[f"d_{role}_loss"] = pna[role]["rel_err"] <= HILL_PNA_LOSS_RTOL
    spec = get_arch("pna")
    shape = spec.shapes["full_graph_sm"]
    cfg = spec.make_config(shape)
    plan = hill_cell("pna_fp32", Grid(("data", "model"), (1, k)))[0].halo_plan
    params = draw_tree(SEED, _gnn_params("pna", cfg), torch.float32, device)
    blocks = [hc.pna_halo_batch(plan, cfg, shape, SEED, r, device) for r in range(k)]
    loss, grads = value_and_grad(lambda p, b: hc.pna_halo_lockstep_loss(p, b, cfg, torch.float64), params, blocks)
    want, got = _host_tree(grads), hill[0]["pna_float64"]["grads"]
    g_err = max(float((got[n] - v).abs().max()) / max(float(v.abs().max()), 1e-30) for n, v in want.items())
    l_err = abs(hill[0]["pna_float64"]["loss"] - float(loss)) / abs(float(loss))
    pna["float64"] = dict(loss=hill[0]["pna_float64"]["loss"], lockstep_loss=float(loss), loss_rel_err=l_err,
                          grad_rel_err=g_err, rtol=HILL_PNA_F64_RTOL,
                          note="the k-block plan's function (padding rows in the loss, padding edges in the "
                               "aggregates) in one process: a one-block plan is another function")
    checks["d_float64"] = l_err <= HILL_PNA_F64_RTOL and g_err <= HILL_PNA_F64_RTOL
    del params, blocks, grads
    # (e)
    wire = {role: [h[role]["collectives"]["all-gather"]["bytes_out"] for h in hill] for role in ("pna_fp32", "t3c")}
    checks["e_bf16_wire_half"] = all(2 * c == f for c, f in zip(wire["t3c"], wire["pna_fp32"]))
    # the host records
    fields = ("tag", "compute_s", "memory_s", "collective_s", "collective_by_type", "peak_bytes", "model_flops",
              "plan", "exchange_model", "counted_wire", "note")
    records = {}
    for name, t in host["targets"].items():
        checks[f"host_{name}"] = t["status"] == "OK"
        if t["status"] == "OK":
            records[name] = dict(status="OK", seconds=t["seconds"], records=[
                dict(status="OK", **{k_: r[k_] for k_ in fields if k_ in r}) for r in t["records"]])
        else:
            records[name] = {k_: t[k_] for k_ in ("status", "seconds", "error", "trace")}
    by_tag = {r["tag"].split()[0]: r for t in records.values() for r in t.get("records", [])}
    if all(checks[f"host_{n}"] for n in host["targets"]):
        checks["host_t3a_above_baseline"] = (by_tag["t3-a"]["collective_by_type"]["total"]
                                             > by_tag["t3-baseline"]["collective_by_type"]["total"])
        checks["host_t2a_peak_below_baseline"] = by_tag["t2-a"]["peak_bytes"] < by_tag["t2-baseline"]["peak_bytes"]
        checks["host_t2c_is_t2a"] = all(by_tag["t2-c"][k_] == by_tag["t2-a"][k_] for k_ in
                                        ("compute_s", "memory_s", "collective_s", "collective_by_type", "peak_bytes"))
    launches = {name: sum(h["launches"][name] for h in hill) for name in hill[0]["launches"]}
    ok = all(checks.values())
    emit("hillclimb", ok=ok, checks=checks, reduced=HILL_REDUCED, counts=counts, accum=accum, decode=decode, pna=pna,
         wire_all_gather_bytes_per_rank=wire, records=records, host_part_seconds=host["part_seconds"],
         meta_seconds=host.get("meta_seconds"), group_seconds=group_s, launches_per_group=launches,
         launches_by_role_rank0=hill[0]["launches_by_role"],
         note="the hand-built cells of repro_torch.launch.hillclimb on the dry run's 4 ranks (1 × 4, gloo); "
              "(a) rank r's real step against the meta step as rank r; the host records: t1, t2, t4 at their "
              "production shapes, t3 at full_graph_sm, all on 16 × 16, traced on meta tensors (the data-sheet "
              "rates: roofline terms, not measurements)")
    require(ok, "hillclimb", f"checks {checks}")
    return launches


def run_dryrun(measured: dict, device: torch.device, host_procs: list, hill_procs: list) -> tuple[dict, dict]:
    """The dry run's line: (a) the host sweep's records (``host_procs``:
    its subprocesses, started beside the sharded phase's group); (b) one train step
    of each `dryrun_jobs` cell on DRYRUN_K ranks sharing the card (gloo),
    its count by kind, bytes in and out and FLOPs equal to the meta run's
    of the same cell; (c) the fp32-wire losses, gradients and updated
    parameters against the k = 1 cells on the card (PNA's and
    EquiformerV2's gradient and parameters in float64), the bf16 / int8
    wire losses against fp32, and
    halo below broadcast; (d) the lm_tp prefill's and the deepfm_sharded
    cells' meta counts equal to what those phases measured. The same group
    then runs the hillclimb's cells (`hill_rank`), whose line
    (`run_hillclimb_line`) also reads ``hill_procs``, the host parts
    started before the GNN phases. Returns the group's K1–K4 launches:
    the dry run's, and the hillclimb's."""
    from repro_torch.launch.dryrun import real_steps
    from repro_torch.launch.mesh import GroupSpec, run_group

    t0 = time.perf_counter()
    jobs = dryrun_jobs()
    spec = GroupSpec(k=DRYRUN_K, backend="gloo", devices=("cuda:0",) if device.type == "cuda" else ("cpu",),
                     timeout_s=DRYRUN_TIMEOUT_S)

    results = run_group(spec, dryrun_rank, [jobs] * DRYRUN_K)
    group_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    refs, by_cell = {}, {}          # jobs that differ only in their grid share one k = 1 cell
    for job in jobs:
        one = dryrun_unsharded(job)
        if job.keep and one.tag() not in by_cell:
            by_cell[one.tag()] = real_steps(0, 1, device, [one])[one.tag()]
        if job.keep:
            refs[job.tag()] = by_cell[one.tag()]
    k1_s = time.perf_counter() - t1
    host = {"sweep": [], "sweep_seconds": []}      # the sweep's records of every part, the rest from part 0
    for part in wait_host(host_procs, "dryrun"):
        host["sweep"] += part.pop("sweep")
        host["sweep_seconds"].append(part.pop("sweep_seconds"))
        part.pop("seconds")
        host.update(part)
    host_wait_s = time.perf_counter() - t1 - k1_s
    checks, line = {}, {}
    # (a) the sweep
    sweep = {f"{r['arch']}/{r['shape']}/{r['mesh']}": (
        dict(status=r["status"], flops=r.get("flops_per_device"), collective_bytes=r.get("collective_bytes_per_device"),
             dominant=(r.get("roofline") or {}).get("dominant"), trace_s=r.get("lower_s"),
             hbm_bytes=r.get("hbm_bytes_per_device"), peak_bytes=(r.get("memory") or {}).get("peak_bytes"))
        if r["status"] == "OK" else dict(status=r["status"], error=r.get("error"))) for r in host["sweep"]}
    checks["a_sweep_ok"] = all(v["status"] == "OK" for v in sweep.values()) and len(sweep) == 2 * len(DRYRUN_SWEEP)
    # (b) meta against the card, exactly
    counts = {}
    for job in jobs:
        tag, meta = job.tag(), host["meta"][job.tag()]
        same = [res[tag]["flops"] == meta["flops"] and res[tag]["collectives"] == meta["collectives"]
                for res in results]
        checks[f"b_{tag}"] = all(same)
        counts[tag] = dict(flops=results[0][tag]["flops"], meta_flops=meta["flops"],
                           collectives=results[0][tag]["collectives"], equal_per_rank=same,
                           op_bytes=results[0][tag]["op_bytes"], meta_op_bytes=meta["op_bytes"],
                           step_s_per_rank=[res[tag]["seconds"] for res in results])
    # (c) sharded against unsharded
    holds = {}
    for job in jobs:
        if not job.keep or job.payload:
            continue
        tag = job.tag()
        holds[tag] = _hold(results[0][tag], refs[tag], job.dtype)
        if job.dtype == "float32" and job.arch == "pna":     # PNA: the loss in fp32, the rest in float64
            holds[tag]["ok"] = holds[tag]["loss_rel_err"] <= DRYRUN_LOSS_RTOL
        checks[f"c_{tag}"] = holds[tag]["ok"] and all(
            abs(res[tag]["loss"] - results[0][tag]["loss"]) == 0.0 for res in results)
    fp32 = results[0][dryrun_jobs()[0].tag()]["loss"]
    for job in jobs:
        if job.payload:
            got = results[0][job.tag()]["loss"]
            holds[job.tag()] = dict(loss=got, fp32_loss=fp32, rel_err=abs(got - fp32) / abs(fp32),
                                    gate=DRYRUN_WIRE_LOSS_RTOL)
            checks[f"c_{job.tag()}"] = abs(got - fp32) <= DRYRUN_WIRE_LOSS_RTOL * abs(fp32)
    halo = results[0][jobs[0].tag()]["collectives"]
    bcast = results[0][next(j for j in jobs if j.comm == "broadcast").tag()]["collectives"]
    checks["c_halo_below_broadcast"] = (halo["all-gather"]["bytes_out"] < bcast["all-gather"]["bytes_out"]
                                        and halo["total"]["bytes_out"] < bcast["total"]["bytes_out"])
    # (d) the dry run of PR 25's phases against what they measured
    sharded = {}
    for key, (stats, by_kind) in measured.items():
        meta = host["sharded"][key]
        same = {kind: meta[kind] == by_kind.get(kind, {"count": 0, "bytes_in": 0, "bytes_out": 0})
                for kind in meta}
        stats_same = stats.get("count", 0) == meta["total"]["count"] and stats.get("bytes", 0) == meta["total"]["bytes_in"]
        sharded[key] = dict(meta=meta, measured=by_kind, measured_stats={k: stats.get(k) for k in ("count", "bytes")},
                            equal=all(same.values()) and stats_same)
        checks[f"d_{key}"] = sharded[key]["equal"]
    launches = {name: sum(res["launches"][name] for res in results) for name in results[0]["launches"]}
    checks["b_k1_launched"] = launches.get("k1_bsr_spmm", 0) > 0
    ok = all(checks.values())
    emit("dryrun", ok=ok, checks=checks, sweep=sweep, sweep_seconds=host["sweep_seconds"],
         meta_seconds=host["meta_seconds"], sharded_meta_seconds=host["sharded_seconds"],
         host_wait_seconds=host_wait_s,
         group=spec.describe(), group_seconds=group_s, unsharded_seconds=k1_s, counts=counts, holds=holds,
         sharded=sharded, launches_per_group=launches, seconds=time.perf_counter() - t0,
         note="(a) one rank of each cell traced on meta tensors in a fake group, on 16 × 16 and 2 × 16 × 16; "
              "(b) rank r's real train step on the card and the meta step of the same cell as rank r: FLOPs "
              "(FlopCounterMode) and collectives by kind (count, bytes handed in, result bytes) equal; "
              "(c) the 4-rank step against the same cell at k = 1 on the card (gradient: AdamW's first moment "
              "/ (1 − b1); parameters where the k = 1 gradient is ≥ DRYRUN_SIGN_FLOOR of its leaf's max in "
              "fp32, every parameter in float64; PNA in float64, its fp32 loss beside; EquiformerV2 in float64); "
              "(d) the meta count of the lm_tp prefill and deepfm_sharded "
              "cells against the same cells' counts in the sharded phases")
    require(ok, "dryrun", f"checks {checks}")
    hill_host = {"targets": {}, "part_seconds": []}
    for part in wait_host(hill_procs, "hillclimb"):
        hill_host["targets"].update(part.pop("targets"))
        hill_host["part_seconds"].append(part.pop("seconds"))
        hill_host.update(part)
    hill = run_hillclimb_line(results, hill_host, device, group_s)
    return launches, hill



HOST_MODES = {"--dryrun-host": dryrun_host, "--hillclimb-host": hillclimb_host}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    emit("setup", ok=True, tf32="off (torch.backends.cuda.matmul and cudnn allow_tf32 = False)",
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), device_count=torch.cuda.device_count())

    build_kernels()
    data = load_graph(device)
    halo = build_plan(data)
    ops = layer_operands(data, torch.Generator().manual_seed(SEED + 1))
    rank = rank_operands(data, halo, ops, torch.Generator().manual_seed(SEED + 2))
    worst = check_kernels(data, ops, rank, halo)
    del rank                 # kept off the card while the unsharded paths run and measure their peak
    torch.cuda.empty_cache()
    run_fake_quant(data, ops)
    main_run = run_main_path(data)
    train_run = run_training(data)
    rows, totals = time_everything(data, ops, main_run, train_run)
    engines = measure_engines(data, totals)
    rank = rank_operands(data, halo, ops, torch.Generator().manual_seed(SEED + 2))
    rows.update(time_bf16_kernels(rank, ops))
    profile_train_steps(train_run)
    profile = profile_kernels(data, ops)
    del rank
    torch.cuda.empty_cache()
    run_af_wide(data)

    # The ranks share the card: free the unsharded tables first, all but what prepare_delta needs (the
    # features and the host's blocked table), which runs beside the elastic group.
    host, inference, train = data["host"], main_run["launches"], train_run["launches"]
    halo_ref = {k: train_run[k] for k in ("grads_bsr_quant_off", "grads_bsr_quant_off_bf16_logits",
                                          "losses_bsr_quant_off")}
    main_run.pop("forward")
    delta_data = {k: data[k] for k in ("host", "n", "x", "labels", "test", "ba")}
    del data, ops, train_run
    gc.collect()
    torch.cuda.empty_cache()
    flat = run_halo(host, halo, main_run, halo_ref)
    sharded, sharded_train = flat["launches"], flat["train_launches"]
    gc.collect()
    torch.cuda.empty_cache()
    tune = prepare_autotune(host, halo)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        hier = run_hier(host, halo, flat, halo_ref, ckpt_dir, tune["plan"])
        tuned = run_autotune_line(tune, hier, engines)
        # The delta phase's script and unsharded references are made in a thread while the elastic group's
        # two ranks run: that phase times nothing but the host's re-plan (replan_host_s shares the host with it).
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            delta_prep = pool.submit(prepare_delta, delta_data, halo)
            run_elastic(host, halo, hier, ckpt_dir, device)
            delta_prep = delta_prep.result()
        del delta_data
    run_obs(flat["tracer"], hier["tracer"], profile)
    del flat
    gc.collect()
    torch.cuda.empty_cache()
    run_serve_graph(host, device)
    gc.collect()
    torch.cuda.empty_cache()
    # The GNN phases' host work (their graph, gnn_train's host runs, gnn_serve's engines) is done in a thread
    # while the delta group runs.
    threads = torch.get_num_threads()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        gnn_built = pool.submit(gnn_host_work, device)
        delta = run_delta(host, delta_prep)
        gnn_built = gnn_built.result()
    torch.set_num_threads(threads)
    del delta_prep
    gc.collect()
    torch.cuda.empty_cache()
    # The hillclimb's host records (no card) run in subprocesses beside the GNN, DeepFM and LM phases; the
    # dry run's line reads them.
    hill_procs = start_host("--hillclimb-host", len(HILL_HOST_PARTS))
    run_gnn(host, halo, device, gnn_built)
    del gnn_built
    gc.collect()
    torch.cuda.empty_cache()
    fm_serve, fm_train, fm = run_deepfm(device)
    measure_dispatch(device)
    gc.collect()
    torch.cuda.empty_cache()
    lm_prefill_run, lm_decode_run, lm = run_lm(device)
    gc.collect()
    torch.cuda.empty_cache()
    lm_train_run, lm_train_err = run_lm_train(device)
    gc.collect()
    torch.cuda.empty_cache()
    moe_run, moe_err = run_moe(device)
    lm["worst"]["k4_flash_attention"] = max(lm["worst"]["k4_flash_attention"], lm_train_err, moe_err)
    gc.collect()
    torch.cuda.empty_cache()
    shard_run = run_sharded(device, beside=lambda: start_host("--dryrun-host", DRYRUN_HOST_PARTS))
    for name, err in shard_run["worst"].items():
        for rows_of in (lm, fm):
            if name in rows_of["worst"]:
                rows_of["worst"][name] = max(rows_of["worst"][name], err)
    shard_launches = {phase: shard_run["launches"].get(phase, {}) for phase in
                      ("lm_tp", "moe_ep", "lm_seq", "lm_tp_train", "deepfm_sharded")}
    gc.collect()
    torch.cuda.empty_cache()
    dry, hill = run_dryrun(shard_run["measured"], device, shard_run["beside"], hill_procs)

    worst = {name: max(err, delta["kernel_errs"].get(name, 0.0)) for name, err in worst.items()}
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=XW_SOURCE if name.startswith("k2_ff_transform") else KERNEL_SOURCE,
             replaces=REPLACES[name],
             launches=inference[name] + train[name] + sharded[name] + sharded_train[name]
             + hier["launches"][name] + hier["train_launches"][name] + tuned[name] + delta["launches"][name]
             + delta["train_launches"][name] + dry[name],
             launches_inference=inference[name], launches_train=train[name],
             launches_per_train_step=train[name] / TRAIN_STEPS, launches_halo=sharded[name],
             launches_halo_train=sharded_train[name], launches_hier=hier["launches"][name],
             launches_hier_train=hier["train_launches"][name], launches_autotune=tuned[name],
             launches_delta=delta["launches"][name],
             launches_delta_train=delta["train_launches"][name], launches_dryrun=dry[name],
             max_abs_err=worst[name], ms=row["ms"],
             plain_ms=row["plain_ms"], bound_ms=row["bound"][0], bound_by=row["bound"][1],
             library_ms=row["library_ms"],
             **({"composition_ms": row["composition_ms"]} if "composition_ms" in row else {}),
             **({"call_ms": row["call_ms"], "timing": "device"} if "call_ms" in row else {"timing": "events"}),
             shape="rank 0 of 4 (halo)" if name not in FP32_KERNELS else "unsharded Nell")
        for name, row in rows.items()
    ] + [
        dict(name=name, route="cuda", source=K3_SOURCE, replaces=REPLACES[name],
             launches=fm_serve[name] + fm_train[name] + shard_launches["deepfm_sharded"][name],
             launches_deepfm_serve=fm_serve[name],
             launches_deepfm_train=fm_train[name], launches_per_train_step=fm_train[name] / DEEPFM_TRAIN_STEPS,
             launches_deepfm_sharded=shard_launches["deepfm_sharded"][name],
             by_shape_sharded={k: dict(ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound"][0], batch=v["batch"])
                               for k, v in shard_run["rows"].items() if v["kernel"] == name},
             max_abs_err=fm["worst"][name], ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound"][0],
             bound_by=row["bound"][1], library_ms=row["library_ms"], call_ms=row["call_ms"], timing="device",
             shape=f"DeepFM train_batch ({row['batch']} × 39 × 10, {'fp32' if name == 'k3_fm_interaction' else 'bf16'})",
             **({"by_shape": {k: dict(ms=v["ms"], call_ms=v["call_ms"], plain_ms=v["plain_ms"], bound_ms=v["bound"][0])
                              for k, v in row["by_shape"].items()}} if "by_shape" in row else {}))
        for name, row in fm["rows"].items()
    ] + [
        dict(name=name, route="cuda", source=K4_SOURCE, replaces=REPLACES[name],
             launches=lm_prefill_run[name] + lm_decode_run[name] + lm_train_run[name] + moe_run[name]
             + sum(shard_launches[p][name] for p in ("lm_tp", "moe_ep", "lm_seq", "lm_tp_train")) + hill[name],
             launches_lm_prefill=lm_prefill_run[name],
             launches_per_prefill=lm_prefill_run[name] / (1 + LM_PREFILL_REPS),
             launches_lm_decode=lm_decode_run[name], launches_lm_train=lm_train_run[name],
             launches_moe=moe_run[name], launches_lm_tp=shard_launches["lm_tp"][name],
             launches_moe_ep=shard_launches["moe_ep"][name], launches_lm_seq=shard_launches["lm_seq"][name],
             launches_lm_tp_train=shard_launches["lm_tp_train"][name], launches_hillclimb=hill[name],
             by_shape_sharded={k: dict(heads=v["heads"], S=v["S"], d=v["d"], window=v["window"], ms=v["ms"],
                                       plain_ms=v["plain_ms"], library_ms=v["library_ms"], bound_ms=v["bound"][0],
                                       bound_by=v["bound"][1])
                               for k, v in shard_run["rows"].items() if v["kernel"] == name},
             max_abs_err=lm["worst"][name], ms=row["ms"],
             plain_ms=row["plain_ms"], bound_ms=row["bound"][0], bound_by=row["bound"][1],
             library_ms=row["library_ms"],
             shape=f"gemma3-12b attention, one sequence: 16 query / 8 kv heads × {row['S']} × 240, causal, "
                   f"{'fp32' if name == 'k4_flash_attention' else 'bf16'}",
             **({"by_shape": {k: dict(window=v["window"], S=v["S"], ms=v["ms"], plain_ms=v["plain_ms"],
                                      library_ms=v["library_ms"], bound_ms=v["bound"][0], bound_by=v["bound"][1])
                              for k, v in row["by_shape"].items()}} if "by_shape" in row else {}))
        for name, row in lm["rows"].items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] and sys.argv[1] in HOST_MODES:      # a host half, started by main() itself (`start_host`)
        sys.path.insert(0, str(SRC))
        HOST_MODES[sys.argv[1]](sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
        sys.exit(0)
    sys.exit(main())

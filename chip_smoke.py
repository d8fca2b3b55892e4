#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (gelly_streaming_tpu_torch).

    python3 chip_smoke.py [--baseline-cu PATH] [--parent-degrees-cu PATH] [--parent-unionfind-cu PATH]
                          [--parent-sage-cu PATH] [--parent-neighborhoods-cu PATH]
                          [--parent-sage-backward-cu PATH] [--parent-csr-cu PATH]
                          [--parent-exact-cu PATH] [--parent-spmv-cu PATH] [--parent-kcore-cu PATH]
                          [--parent-spanner-cu PATH] [--parent-sampler-cu PATH]
                          [--parent-matching-cu PATH] [--parent-sketches-cu PATH]

Needs one CUDA GPU (built for an H100, sm_90a) and nvcc.  It builds the
port's CUDA kernels from ``gelly_streaming_tpu_torch/csrc``, holds each
kernel against its plain PyTorch twin on the card (random panes from 32 to
16384 vertices, a star, a Zipf-skewed pane, a complete graph whose total
passes 2^32, an empty pane, edges on bit 31 and on word boundaries, and
unaligned inputs), then drives the port's main path, ``window_triangles``
over an event-time ``EdgeStream``, at the size of the repo's triangle bench
(16 windows of 2^17 edges over 4096 vertices, plus one 8192-vertex window
and one sparse-id window that takes the CSR path), checks every window's
count and holds both kernels against their twins on every dense window.
Tolerance: none; both kernels compute integers and must equal their twins
exactly (``max_abs_err`` 0).

Phase 5 times each kernel three ways: CUDA events around back-to-back
calls (``ms``, the host's enqueue time included when it is the longer),
events around calls enqueued while ``torch.cuda._sleep`` holds the stream
(``device_ms``, the device alone), and the host's enqueue time per call
(``host_us``).  ``--baseline-cu`` names another build of
``pane_triangles.cu`` with the C interface of the first port slice (caller
zeroes the outputs); its two kernels are then timed the same way, in turns
with the current ones (baseline, current, current, baseline).

Phase 6 holds the union-find kernels (``csrc/unionfind.cu``) against their
plain twin on the card at 2^20 vertices: uniform, star, Zipf, a 2^20-vertex
path inserted in reverse order and shuffled, self-loops, a masked tail,
ids at capacity - 1, an incoming forest whose roots are not the smallest
ids, and ``merge_parents`` of two such forests; parent and seen must be
equal exactly.  Phase 7 drives the streaming CC main path at the size of
the repo's CC bench (bench.py): 50 batches of 2^21 uniform edges over 2^20
vertices (seed 0), packed EF40 by ``pack_stream`` (untimed), through
``EdgeStream.from_wire(...).aggregate(ConnectedComponents())`` on the
card; the final labels must equal both the plain twin folding the same
batches on the card and scipy's connected components (smallest id per
component).  A ``from_arrays`` stream with ``ingest_window_edges`` set
checks every running emission the same way.  The two union-find kernels
are timed on the main path's last batch: ``ms`` by torch.profiler where it
shows them, and ``device_ms``/``host_us`` on a held stream, compress as
the call with no edges and the union kernel as the whole call minus it.
The run must launch ``ef40_unpack`` (``csrc/wire_decode.cu``) once a
batch and never its twin (as must phases 9, 10 and 18 (a)); the kernel
is held to the twin on the last batch and timed on a held stream beside
its bytes bound and the twin.

Phases 8-10 drive the GraphStream surface on the same stream (packing
runs on host threads, untimed).  Phase 8: ``EdgeStream.from_arrays(...)
.get_degrees()`` over all 104,857,600 edges (209,715,200 records,
downloaded packed); every vertex's final degree must equal ``np.bincount``
and the first batches' records the twin's; ``get_in_degrees``,
``number_of_vertices``, ``number_of_edges`` and ``get_vertices`` on an
8-batch prefix and ``undirected().distinct()`` on a 2-batch prefix must
equal numpy.  Phase 9: ``DegreeDistributionSummary`` over the EF40 replay
(deg equal to ``np.bincount``), ``DegreeDistribution`` over 2^20 signed
events on 2^16 vertices in batches of 2^15 (equal to a host oracle written
as the reference's three keyed stages) and over a run at capacity 2^10
whose hubs pass it (equal to the CPU path), then uncut over the CC bench's
stream with signs (about 30% deletions) in batches of 2^21: events/s and
records/s end to end, every batch's records equal to the twin on the card,
the first batch's to the one-thread kernel, the final histogram to
``np.bincount`` of the final degrees.  The two-stage scan and the one-thread
kernel are timed in turns at 2^15 and 2^21 events, the two stable sorts
apart.  Phase 10: ``BipartitenessCheck`` over an even -> odd
EF40 stream of the bench's shape (bipartite; sides differ across every
edge; components equal to scipy's) and over the uniform stream
(``(false,{})``), and a timed windowed run whose every emission must equal
the CPU path's.  Each new kernel (``degree_trace``, ``degree_fold``,
``degree_dist_scan``, ``parity_union_kernel``) must launch once a batch on
its main path and equal its twin; ``index_add_`` is timed beside
``degree_fold`` as the library call.  Phase 9 also holds ``degree_fold``
against its twin on phase 12's hub pane, a masked batch and one with ids
-1, C and C + 5, times it on the uniform and the hub batch, and measures
the L2's reduction rate (``degree_l2_probe_launch``: 2^22 reductions at
hashed indices of a 4 MiB vector, and 2^17 on one address), printed beside
the bytes bound.

Phases 6-10 also hold the kernels against their twins with ids -1, C and
C + 5 on some rows of the main path's batches (unvalidated streams may
carry them; the port follows JAX's index rules), and print the union
calls' hook and doubling round counts on a first and a late batch.  The
main path's first fold compresses the fresh state; later folds find it
known flat and skip the compress kernels.  Phase 7 prints the compress call
with no edges by kernel (the pass and the rounds kernel), and with
``--parent-unionfind-cu`` the split of the parent's compress call on the
flat state: its header memset, then variants of its cooperative kernel with
one part taken out (``COMPRESS_SPLIT``: the launch alone, one round with no
sync, the sync with no round).  Phase 11, with ``--parent-degrees-cu`` /
``--parent-unionfind-cu`` (those sources as they were before the redesign
of degree_fold and compress, d65530e, with that C interface), times the
parent's degree_fold on the uniform and the hub batch, its compress (a call
with no edges) on the flat state, a ``uf_forest`` and a path at C and 2C
nodes, and its union calls (first and late batch, CC and parity) in turns
with the current ones on the held stream (parent, current, current,
parent).

Phase 12 drives ``slice()`` and windowed GraphSAGE at the repo's width (F_in
= F_out = 128, bench.py:2762) over the CC bench's vertex count: 8 count-cut
panes of 2^21 uniform edges over 2^20 vertices and one hub pane (a star of
2^17 beside Zipf edges), ``EdgeStream.from_arrays(...).slice(window,
EdgeDirection.ALL)`` into ``GraphSAGEWindows(params, features).run``.
Windows/s, edges/s and embeddings/s end to end; every pane's
``build_buckets`` (``csrc/neighborhoods.cu``) equal to its twin on the card
exactly, also with ids -1, C and C + 5, and its radix sort's order equal to
``torch.sort(stable=True)``'s; ``sage_layer`` (``csrc/sage.cu``, the fused
layer) within 2^-7 * |ref| + 2^-9 of its twin (one bf16 step of the output,
plus a one-step change of a mean carried through W ~ N(0, 1/128)), the
buckets of rows that go through the partial-sum kernel reported on their
own; windows 0 and 8 against a float64 oracle (numpy, scipy) of the
grouping and the layer at 2e-2 * (1 + |ref|); a 2-layer stack over 2 panes
against its run on the twins; a ``fold_neighbors`` degree count against
``np.bincount``; both kernels launched on the main path.  On the first
(uniform) and the hub pane it times, on a held stream, the build (radix
sort, count and scatter calls), the radix sort alone,
``torch.sort(stable=True)`` of the same keys (the build's library
yardstick, on no path), the whole call, the layer over the pane's buckets
and ``embedding_bag(mode="mean")`` + ``addmm`` (the layer's yardstick);
with ``--parent-sage-cu`` / ``--parent-neighborhoods-cu`` (those sources
as they were before the fused layer and the radix sort, with that C
interface) the parent's layer (its gather, then ``addmm`` and ReLU) and
build (``torch.sort``, then its count and scatter) in turns with the
current ones (parent, current, current, parent).  Then a window stage by
stage (host pad, upload, build, layer, readback) and the device's busy
share by torch.profiler.

Phase 13 trains GraphSAGE at F = 128 through ``sage_init_train``,
``sample_pairs`` and ``sage_train_step``: (a) the JAX bench's own batch
(bench.py:2762-2812: K = 4096, D = 32, valid with p = 0.8, 2^14 vertices,
Adam at lr 1e-2), 20 steps, step p50, pairs/s, the loss falling, the
device's idle share; (b) every bucket of phase 12's first uniform pane
through ``slice(ALL)`` (~1.03M keys over 2^20 vertices), one step a bucket
for 3 passes, the row-weighted loss a pass falling, then the hub pane's
buckets once (rows past 32 slots), peak memory, ``build_buckets``,
``sage_layer`` and ``sage_layer_backward`` launched on that run (two layer
calls and two backward calls a step); (c) ``sage_layer_backward``
(``csrc/sage.cu``, the layer's weight gradient) against its twin on every
bucket of (a) and (b), dw within 2^-7 * |A|^T |dH| and db within 2^-10 *
sum |dH| (one bf16 step of each A entry carried through the product), two
runs equal bit for bit, and a whole step's loss and gradients against
autograd of the plain twin within rtol 2e-2 and rtol 5e-2 / atol 5e-3;
(d) the backward over the uniform pane's buckets, device only on the
held stream, its bound, the twin, and ``embedding_bag(mode="mean")`` +
``mm(A^T, dH)`` as the yardstick; then over the same steps' contexts (2K
rows a bucket, D = 0; their bound counts the self half's product alone),
both calls' kernels split by torch.profiler (the reduce's share), ptxas'
registers and spills of the tensor-core instantiations, and the forward
``sage_layer`` over the contexts; with ``--parent-sage-backward-cu``
(``sage.cu`` as it was before the tensor-core backward, the same C
interface) the parent's backward over the buckets and over the contexts,
and its layer over the contexts, in turns with the current ones (parent,
current, current, parent).

Phase 14 drives the asynchronous window pipeline (``cfg.async_windows``)
and the windowed superbatch planes (``cfg.superbatch``): (a) the reference's
windowed-CC bench shape (bench.py:310-395: 100 windows of 2^13 edges over
2^16 vertices, batches of 2^12, 100 ms windows, seed 3), sync against async
4 after a warm-up run of each, every emission's parent read to the host and
equal element for element, edges/s, their ratio and the pipeline counters;
(b) the same query at the CC bench's width (16 windows of 2^21 uniform
edges over 2^20 vertices, seed 0; 50 batches cut to 16 windows for time),
sync, async 4, superbatch 4 and both, records equal across the four,
windows/s and edges/s, and the device's idle share of an async run (its
busy time by torch.profiler over that run's own wall); (c) ``window_triangles`` over phase 4's stream on the async
and the superbatch plane, counts equal to the sync path and
``plain_pane_count``, ``csr_triangles`` (``csrc/csr_triangles.cu``, the
masked-CSR count of K panes) equal to its twin on every superbatch group;
(d) ``csr_triangles`` alone on a held stream at the superbatch group, the
sparse CSR window and phase 12's hub pane (counted through
``window_triangles``' sync path and alone, both held against a scipy
oracle), with its bytes bound, the design figure (the lookups, their rate,
the entry bytes), scratch, split by kernel, twin and
``torch.sparse.sampled_addmm`` as the library yardstick; ``--parent-csr-cu``
names 8ff7365's ``csr_triangles.cu``, driven through its three C calls
around ``neighborhoods.cu``'s radix sort, equal to the current kernel and
timed in turns with it (parent, current, current, parent) at the three
shapes; (e) ``reduce_on_edges`` over 4 of phase 12's uniform
panes, sync against async 2, records equal, and the dispatch stall that
``build_buckets``' host read of the bucket counts adds.

Phase 15 drives the streaming ``ExactTriangleCount``: (a) block mode over a
Watts-Strogatz small world (n = 2^20, ring degree 16, rewiring 0.1, seed
5: 8,388,608 shuffled edges) through ``EdgeStream.from_arrays(...)`` at C
= 2^20, D = 64, batches of 2^16: no row overflows (``dropped == 0``), the
final per-vertex and global counts equal scipy's (A @ A) * A exactly, the
first 4 batches' blocks equal the twin's on the card; edges/s and
records/s end to end, the fold of one batch on a held stream (each call on
its own copy of the state) beside its bytes bound, the emission on the
card against the JAX package's host diff of the whole counter vector, and
the device's idle share of one run by torch.profiler; (b) block mode over
Graph500's Kronecker generator (scale 18, edge factor 16, A, B, C = 0.57,
0.19, 0.19, seed 6: duplicates and self-loops) at C = 2^18, D = 64, where
hub rows overflow (``dropped > 0``): the state and blocks equal the
twin's after each of the first 16 batches (2^20 edges; the twin's time cuts
the rest), the same figures as (a); (c) trace mode over (a)'s first 2^16
edges in batches of 2^12: every record and the final state equal the
twin's.  On the card the twins replay their steps from a CUDA graph (the
same ops, without the host's launch cost).  Both folds
(``csrc/exact_triangles.cu``) must make one C call a batch, the wrappers
call no twin, and every batch of (a), (b) and (c) must take the parallel
path (the fold's device counters); the phase prints the fixed point's
passes a batch, each fold's split by launch (torch.profiler) and scratch,
and a late batch of (a) held against the twin.  ``--parent-exact-cu PATH``
times an earlier ``exact_triangles.cu`` with the one-launch C interface
(5e8e61b's) in turns with the current folds at (a) batch 4 and the last
batch, (b) batch 15 and (c), and holds their states equal.

Phase 16 drives the masked-semiring SpMV core (``ops/spmv.py``) and its
four algorithms on Graph500's Kronecker generator (scale 20, edge factor
16, A, B, C = 0.57, 0.19, 0.19, default_rng(7): 16,777,216 edges over
2^20 vertices, duplicates and self-loops kept, weights U[0, 1) f32) cut
into 4 tumbling windows of 2^22 edges: (a) ``windowed_sssp`` from the
vertex with the most out-edges in window 0, in auto, push and pull:
distances bit-equal across modes; each window's ``spmv_fixpoint``
(``csrc/spmv.cu``, one cooperative launch a fixpoint) equal to its twin on
the card (x, frontier, iterations, push/pull split, switches, histogram);
reached sets equal to scipy's Dijkstra (the least weight of repeated
edges) and distances within rtol 1e-5 of its float64; (b)
``windowed_pagerank`` (damping 0.85, tol 1e-6, max_iters 100): push, pull
and a second run bit-identical; ``pagerank_fixpoint`` against its twin on
the card: in_window exact, iterations within 1, ranks within rtol 1e-5 /
atol 1e-9, each window's ranks summing to 1 within 1e-4; every window's
``pagerank_fixpoint`` timed on a held stream (ms an iteration, its bound,
host µs a call, the grid's blocks) beside one iteration's spread as a
cuSPARSE CSR SpMV (``torch.mv``, f32 sums: a yardstick, not the same
function); (c)
``windowed_kcore``: one ``kcore_fixpoint`` launch a pane (``csrc/kcore.cu``,
every round in one cooperative launch), each window's cores and rounds
equal to the twin's per-bucket rounds on the card and to ``pane_cores``
through ``kcore_round`` (one C call a bucket a round), each round replayed
from its start through the new kernel equal to the per-bucket kernel's
round, and on a scale-14 pane equal to Batagelj-Zaversnik peeling; (d)
``IterativeConnectedComponents`` over the CC bench's first 16 batches
(phase 7's stream): every record block equal to a run on the twin, final
labels equal to scipy's components; (e) the JAX bench's own SpMV shape
(bench.py:785-865: C = 2^15, 2^18 edges, Zipf 1.2 sources,
default_rng(17)): the force-push over auto wall ratio, PageRank's
edge-iterations/s, auto, push and pull bit-equal.  Each kernel is timed on
a held stream beside its bytes bound and its twin: every window's
fixpoint in auto, forced push and forced pull, PageRank's every window, each
k-core round replayed from its start and each pane's whole fixed point;
the cost of one grid-wide sync at each fixpoint's block count (a probe
source written and built by this script, ``GRID_SYNC_PROBE_CU``); (e)'s
fixpoint (a block a pull tile) in turns with builds whose grid takes a
thread a vertex, and a thread a vertex and an edge (``GRID_SPLIT``); (b)'s
iteration split by builds with the tiles or the vertex phase taken out
(``RANK_SPLIT``);
auto's threshold swept over 0.01-0.5 at (a) window 0 and (e), printed
only.
``--parent-spmv-cu PATH`` (9717394's ``spmv.cu``) times its
``pagerank_fixpoint`` (one warp a hub's in-segment) in turns with the
current one on every window of (b); ``--parent-kcore-cu PATH`` (a48e429's
``kcore.cu``) its per-bucket round and ``pane_cores`` in (c); outputs held
equal.

Phase 17 drives the spanner, the greedy weighted matching and the sampled
triangle estimators through their entry points, each kernel held against
its twin on the card: (a) ``from_arrays(...).aggregate(Spanner(1000, 2))``
at ``measurements spanner``'s defaults (2^17 uniform edges over C = 512, D
= 64, batches of 2^14, default_rng(0); not cut): the table equal to the
twin's after every batch, the first batch's equal to a sequential Python
BFS spanner (an oracle independent of both packages), each batch's capped
candidates and survivors of the exact pre-pass equal to the plain model's
(``ops/spanner.exact_prepass_plain`` on the table before the batch); (b)
k = 3 at BASELINE.md's scaled shape (C = 4096, D = 64, its 524,288 edges)
with ``body`` auto, balls and bfs, the three tables equal, and every batch
of the auto run equal to the plain model (its pre-pass on the card, its
walk over the survivors on the host), candidates and survivors included;
(c) ``combine`` of (a)'s two halves' spanners equal to the twin's; (d)
``CentralizedWeightedMatching.run`` at ``measurements matching``'s
defaults (2^16 edges over 2^12 vertices, f32 weights U[0, 1), batches of
2^13) and over a generated MovieLens-100K-shaped stream (100,000 distinct
ratings between 943 users and 1,682 items, weights 1-5), every batch's
events, emask and state equal to the twin's and to the plan
(``ops/matching.matching_rounds_plain``), its rounds from the device
counters equal to the plan's, the run loop (one batch deep, pinned
copies) against 5030d41's blocking loop in turns (``LOOP_TURNS``), and an
evicting chain where every lane conflicts (one edge a round), timed; (e)
``BroadcastTriangleCount(1000)`` over the first 2^20 edges of phase 15
(a)'s Watts-Strogatz stream in batches of 2^16 (cut for the twin's time),
every batch's state (key included) and estimate equal to the twin's.  Each
kernel (``spanner_admit``, ``matching_scan``, ``sampler_scan``) must make
one C call a batch on its path; each path prints edges/s end to end, the
kernel's device ms a batch on a held stream (each call on its own copy of
the state before the batch), host µs a call, the twin's ms, its bound and
the device's idle share (one less the path's kernel calls' device time,
each call held, over the run's wall).  The spanner's lines print the
survivors against the capped candidates and what a survivor costs ((a)'s
batch 0, its late batch, (b)'s run of C calls); (e) prints the host key
chain's ns a hash with the host CPU's model name, and in how many batches
of the run loop batch k + 1's keys were ready while the card still ran
batch k.  ``--parent-spanner-cu PATH`` / ``--parent-sampler-cu PATH``
(c34004e's sources) time the parent's calls in turns with the current
ones (parent, current, current, parent): (a)'s late batch and batch 0,
(b)'s whole run of C calls (auto and bfs), and (e)'s batches;
``--parent-matching-cu PATH`` (5030d41's one-thread scan) (d)'s last
batches and the chain, outputs held equal.

Phase 18 drives the fixed-state sketches through their entry points: (a)
``HLLDegreeSummary(eps=0.01)`` (m = 2^16) and
``CountMinHeavyHitters(eps=0.001, delta=0.01, top_k=16)`` (d = 5, w =
4096) over phase 7's EF40 replay, an emission every 8 batches; (b)
``SketchTriangleCount(eps=0.05, delta=0.05)`` (R = 4096, M = 8192) over
2^20 edges drawn with repeats from phase 17 (e)'s Watts-Strogatz ring cut
to 2^13 vertices (2^16 edges: the sample closes wedges at every emission),
in batches of 2^16; (c) the
JAX package's three accuracy contracts at its own shapes
(tests/test_sketches.py:113-170), asserted as it asserts them.  Every
batch's state and every emission equal the twins' on the card
(``hll_fold``, ``cm_fold``, ``tri_fold``; ``tri_sampled_closures`` at each
emission), the closure counts a numpy pair-enumeration oracle's; each
update is one C call a batch.  It prints edges/s end to end, each kernel's
device ms a batch held, host µs a call, the twin's ms, its bound, the
library call (``scatter_reduce_`` amax, ``index_add_``) on precomputed
inputs, the idle share, and the estimates' relative errors against exact
oracles (not asserted).  ``hll_fold`` and ``cm_fold`` are also timed on
(a)'s first batch (cold registers); ``tri_fold`` on (a)'s last batch of
2^21 edges folded into (b)'s final sample, ``tri_sampled_closures`` on
the star sample (R rows on vertex 0), both held against the twins, and
each must enqueue one launch and no memset a call (the nodes of a call
captured into a CUDA graph, and torch.profiler's runtime calls).
``--parent-sketches-cu PATH`` (e057c38's ``sketches.cu``, before the
one-launch ``tri_fold`` and the grouped closure count) times its two
kernels in turns with the current ones on those four inputs (parent,
current, current, parent; outputs held equal first), beside the split of
the parent's time (``TRI_SPLIT``, and its fold with no edge) and the
design's variants (``TRI_DESIGNS``), each built from its source beside
the main build (one that fails to build is reported and skipped).

Phase 19 drives checkpoints, supervised recovery and the binned and
compressed ingest over the CC bench's stream (50 × 2^21 uniform edges over
2^20 vertices, not cut), each run through ``EdgeStream.from_arrays(...)
.aggregate(ConnectedComponents(), ...)`` with ``superbatch=8`` (a group's
batches packed across the ingest pool).  The host ingest library
(``csrc/edge_parser.cpp``) is built in phase 1 beside the kernels and must
load.  (a) ``wire_checkpoint_batches=8``: three pairs of runs with
snapshots and without, in turns (edges/s); a snapshot's device clone ms
and the writer's save ms; then a subclass whose ``update`` raises on its
27th call, run under ``run_supervised(..., max_restarts=1)``: one restart,
the snapshot at the restart says batch 24, the union kernel launches once
a batch after the restore (26 times, no refold of batches 0–23), the time
from the new ``aggregate`` call to the first fold after the restore, and
the labels equal to the uncrashed run's and scipy's; the idle share of
one snapshotted run by torch.profiler.  (b) ``wire_compress=1``
and ``binned_ingest=1`` (plain width) alone: labels equal to (a)'s and
scipy's, ``bdv_decode`` (``csrc/wire_decode.cu``) launched once a batch,
the native sorter (and encoder, or PAIR40 packer) called on every batch
(``utils/native.CALLS``); edges/s, wire bytes an edge against the plain
width and EF40, one batch's pack ms, ``bdv_decode``'s device ms on a held
stream, its bound (the payload, not the bucket's padding, read once), its
ratio and the twin's ms, and the idle share of one run by torch.profiler
(as (a)'s); with ``--parent-wire-decode-cu`` 5985037's decode in turns
with the current one and the split of both (``BDV_SPLIT``,
``BDV_DESIGNS``).  (c) ``bdv_decode`` against its twin on the card, bit
for bit: a CC batch, a group arena's four rows of different widths (each
read at the arena's width), varints at the 1/2/3/4-byte boundaries, ids
up to 2^28 - 1, the valued layout, n in {0, 1, 3, 5}, bucket padding,
truncated buffers and 4,096 random-byte buffers (clipped reads); then
``ef40_unpack`` against its twin on 547 buffers, one launch each (the CC
batch, packed batches with n from 1 to 2^21 and C up to 2^20, odd n,
bitvectors with no, every, too few and too many ones, C = 0, views at
offsets 1-15, 512 random-byte buffers).  Alone: ``chip_smoke.
phase_checkpoints(torch.device("cuda", 0), chip_smoke.sleep_cycles_per_ms(),
chip_smoke.cc_bench_stream())`` after ``_cuda.build_all()`` (it computes
scipy's labels itself when phase 7 did not).

Phase 21 drives the mesh aggregation plane with its shards sharing the
one card (so no multi-GPU speed is measured): (a) CC's mesh wire
streaming fold over the CC bench's stream at batch 2^21, 4 shards with
rows of 2^19, through ``MeshAggregationRunner(...).wire_records``: the
owner-sharded plane from arrays (the dense exchange, ``slab_fold``, the
regime the runner recorded checked) and
from replayed rows, the replicated plane (the pmin fixed point) from the
rows, each run's labels and ``seen`` equal to phase 7's bit for bit; then
a run with a snapshot every 25 groups killed after group 37 and resumed
(the snapshot says group 25; the resume folds groups 25-49 alone).  It
prints edges/s, exchange rounds, host syncs, the comms counters, every
kernel's launches and the device's idle share (torch.profiler).  (b) the
windowed owner-sharded plane over 16 ingestion-count windows of 2^15
edges on 2^20 ids (window 5 half on one hub): CC (round robin, the delta
regime: ``owner_pack``, ``block_delta_fold``) and the degree summary
(``route_key="src"`` with binned ingest, through
``io/ingest.parallel_host_route``), every record equal to a
single-partition run's, the exchanges counted by the regime each took
(as the runner recorded it, with its delta capacity); the replicated
bipartiteness check over a near-bipartite stream.  (c) ``measurements
routing`` on an explicit 8-shard mesh of the card (2^20 edges a shard,
alpha 1.3, seed 0, a capacity the plain router overflows), equal to the
same call on the CPU.  (d) the three routing kernels against their twins
(random inputs, every changed row in one owner with one slot, empty and
all-DELTA_PAD buffers, 2^20 + 333 items for the scan carry's later
passes, each op, S in {2, 4, 8}), then each checked against its twin
again and timed on a held stream at (a)'s and (b)'s shapes beside its
bound, twin and library call.

It prints timings, a ``{"kernels": [...]}`` JSON line, the GPU's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.  Any
failed phase exits non-zero without that line; so does a machine without
CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8 ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12  # dense, the tensor cores

WINDOW_MS = 1000
PANE_EDGES = 1 << 17
PANE_VERTICES = 4096
DENSE_WINDOWS = 16
TIMED_REPS = 200

# the streaming CC main path at bench.py's size (bench.py:2190-2192, 2276-2306)
CC_VERTICES = 1 << 20
CC_BATCH = 1 << 21
CC_BATCHES = 50
CC_EMIT_BATCHES = 8  # from_arrays prefix with running emissions
CC_EMIT_EVERY = 2  # batches per emission on that prefix
UF_REPS = 20

# phases 8-10 on the CC bench's stream, and the signed degree-distribution runs
PROP_TWIN_BATCHES = 4  # degree trace batches held against the twin
PROP_PREFIX_BATCHES = 8  # prefix for the other property streams
PROP_DISTINCT_BATCHES = 2  # prefix for undirected().distinct()
DD_EVENTS = 1 << 20  # signed events of the DegreeDistribution run
DD_VERTICES = 1 << 16
DD_BATCH = 1 << 15
DD_CAP = 1 << 10  # the capacity run: hubs' degrees pass it
DD_CAP_EVENTS = 1 << 16
BP_WINDOW_EDGES = 1 << 18  # the timed windowed bipartiteness run
BP_WINDOW_VERTICES = 1 << 16

# phase 12, GraphSAGE's main path: the repo's width (bench.py:2762,
# examples/measurements.py:855-857) at the CC bench's vertex count
SAGE_VERTICES = 1 << 20
SAGE_FEATURES = 128
SAGE_PANE_EDGES = 1 << 21
SAGE_PANES = 8  # uniform panes, then one hub pane
SAGE_HUB = 1 << 17  # the hub pane's star
SAGE_TOL = 2e-2  # embeddings: the JAX package's bound between its GraphSAGE planes
# sage_layer against its twin: both round the mean once to bf16 (at most one
# bf16 step apart where the f32 sums' order flips a rounding; a one-step
# change of a mean carried through W ~ N(0, 1/128) stays below 2^-9) and the
# output once (one bf16 step, 2^-7 of the value, where the products' order
# flips it)
SAGE_TWIN_RTOL, SAGE_TWIN_ATOL = 2.0 ** -7, 2.0 ** -9
# the mean alone against the twin's (W = [0; I], no bias, a table of values
# >= 1): one bf16 step of the mean, which a dropped or doubled chunk of a hub
# row's sum would pass by far (the layer check above cannot see the mean at
# a hub row: there it moves the output by about its own tolerance)
SAGE_MEAN_RTOL, SAGE_MEAN_ATOL = 2.0 ** -7, 1e-6
SAGE_REPS = 20
# the layer alone at other widths (F_in, F_out) over the uniform pane's
# buckets: wgmma with W's columns padded to 64, several n-tiles, K chunks;
# the CUDA cores at the 602 features of the GraphSAGE paper's Reddit graph
SAGE_WIDTHS = ((256, 256), (640, 128), (64, 40), (602, 41))
SAGE_HUB_REPS = 10  # the hub pane's 21 buckets: keep the held stream under ~1000 launches

# phase 13, GraphSAGE training: the JAX bench's own batch (bench.py:2762-2812:
# K = 4096 keys of D = 32 slots, valid with p = 0.8, features normal over
# 2^14 vertices, F = 128, optax.adam(1e-2)), then every bucket of phase 12's
# first uniform pane and, once, of its hub pane
TRAIN_BENCH_K, TRAIN_BENCH_D, TRAIN_BENCH_C = 4096, 32, 1 << 14
TRAIN_LR = 1e-2
TRAIN_BENCH_STEPS = 20
TRAIN_PASSES = 3  # one step a bucket a pass over the uniform pane
# sage_layer_backward against its twin: both rebuild A = [x_self | mean] in
# bf16, a mean at most one bf16 step apart (the kernel multiplies by the
# count's reciprocal, the twin divides); carried through the product that
# is 2^-7 |A|^T |dH| for dw, and the f32 sums' order (blocks' partials
# against torch's reduction) stays far inside it; db sums dH alone
SAGE_BWD_RTOL, SAGE_BWD_DB_RTOL = 2.0 ** -7, 2.0 ** -10
# a whole step against the twin's autograd: the JAX package's bounds between
# its training planes (tests/test_graphsage.py:164,170-173)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 2e-2, 5e-2, 5e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events: the device's time, or the host's when it enqueues slower."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sleep_cycles_per_ms() -> float:
    """Rate of ``torch.cuda._sleep``'s spin, in cycles per ms of the card."""
    import torch

    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def device_ms(fn, reps: int, cycles_per_ms: float, warmup: int = 3):
    """(device ms per call, host enqueue us per call) of ``fn``.

    A ``torch.cuda._sleep`` holds the stream while all ``reps`` calls are
    enqueued; events recorded after the sleep and after the last call then
    bracket the device's work alone.  The hold is checked: if the sleep
    had ended before the last call was enqueued, it is lengthened and the
    run repeated."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    hold_ms = max(2.0, 3e3 * reps * (time.perf_counter() - t0) / warmup)
    torch.cuda.synchronize()
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0
        end.record()
        held = not start.query()  # the sleep still ran after the last enqueue
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps, host_s / reps * 1e6
        hold_ms *= 4
    raise RuntimeError("the host could not enqueue the timed calls inside the hold")


def profiler_device_us(fn, reps: int):
    """torch.profiler's device time per call of each kernel or memset that
    ``fn`` runs: {name: (us per call, calls)}; empty when the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us and evt.count:
            rows[evt.key] = (us / evt.count, evt.count)
    return rows


# ---------------------------------------------------------------------------
# inputs


def to_dev(arrays, dev):
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)


def seeded_pane_words(rng, k: int, edges: int):
    """Packed words of a random pane over [0, k) with duplicates, both
    orientations and self-loops, plus garbage words past n."""
    u = rng.integers(0, k, edges)
    v = rng.integers(0, k, edges)
    dup = rng.integers(0, edges, edges // 4)
    loops = rng.integers(0, k, 16)
    return edge_words(rng, k, np.concatenate([u, v[dup], loops]), np.concatenate([v, u[dup], loops]))


def edge_words(rng, k: int, u, v):
    """Host (int32 words, int32[1] n) of an edge list, with garbage words
    past n that the kernel must ignore."""
    from gelly_streaming_tpu_torch.ops import dense_triangles as dt

    w, n = dt.pack_pane(np.asarray(u), np.asarray(v))
    if int(n) == len(w):  # make room for padding that must be ignored
        w = np.concatenate([w, np.zeros_like(w)])
    w[int(n):] = (rng.integers(0, k, len(w) - int(n)) | (1 << 14)).astype(np.uint32)
    return dt.packed_host_arrays(w, n)


def star_edges(rng, k: int):
    """Vertex 0 joined to every other vertex (a row of degree k - 1, all
    of it oriented work), plus 2k random edges among the leaves."""
    leaves = np.arange(1, k)
    u = np.concatenate([np.zeros(k - 1, np.int64), rng.integers(1, k, 2 * k)])
    v = np.concatenate([leaves, rng.integers(1, k, 2 * k)])
    return u, v


def zipf_edges(rng, k: int, edges: int, a: float = 1.2):
    """Edges whose endpoints follow a Zipf law over the ids: hub rows at
    low ids, so their neighbours are nearly all above them."""
    p = 1.0 / np.arange(1, k + 1) ** a
    p /= p.sum()
    return rng.choice(k, edges, p=p), rng.choice(k, edges, p=p)


def boundary_edges(k: int):
    """A complete graph on vertices at bit 0 and bit 31 of words and at the
    ends of the row."""
    ids = sorted({x for x in (0, 1, 30, 31, 32, 33, 63, 64, 95, 96, 127, 128,
                              k - 33, k - 32, k - 31, k - 2, k - 1) if 0 <= x < k})
    pairs = [(a, b) for a in ids for b in ids if a < b]
    return np.array([a for a, _ in pairs]), np.array([b for _, b in pairs])


def adjacency(k: int, u, v) -> np.ndarray:
    adj = np.zeros((k, k), bool)
    adj[u, v] = True
    adj[v, u] = True
    np.fill_diagonal(adj, False)
    return adj


def numpy_six_triangles(adj: np.ndarray) -> int:
    """trace(A^3) = sum(A * (A @ A)) for symmetric A, in numpy (float32
    matmul: entries < 2^24 are exact)."""
    a = adj.astype(np.float32)
    return int(((a @ a) * a).sum(dtype=np.float64))


def word_err(got, want) -> int:
    """Max |difference| of two int32 bitsets, words read as uint32."""
    import torch

    torch.cuda.synchronize()
    mask = 0xFFFFFFFF
    return int(((got.long() & mask) - (want.long() & mask)).abs().max())


# ---------------------------------------------------------------------------
# phases 2-3: each kernel against its twin


def phase_adjacency(dev, rng) -> int:
    from gelly_streaming_tpu_torch.ops import dense_triangles as dt

    cases = [(f"K={k}", k, seeded_pane_words(rng, k, 8 * k + 3))
             for k in (32, 96, 128, 4096, 8192, 16384)]
    cases += [
        ("star K=4096", 4096, edge_words(rng, 4096, *star_edges(rng, 4096))),
        ("Zipf K=4096, 2^17 edges", 4096, edge_words(rng, 4096, *zipf_edges(rng, 4096, PANE_EDGES))),
        ("bit 31 / word edges K=4096", 4096, edge_words(rng, 4096, *boundary_edges(4096))),
        ("bit 31 / word edges K=96", 96, edge_words(rng, 96, *boundary_edges(96))),
        ("empty pane K=4096", 4096, edge_words(rng, 4096, [], [])),
    ]
    worst = 0
    for name, k, host in cases:
        words, n = to_dev(host, dev)
        views = [("", words, n)]
        if len(words) > 1:  # a view 4 B off alignment takes the scalar loads
            views.append((", unaligned", words[1:], n - 1 if int(n[0]) > 0 else n))
        for tag, w, nn in views:
            got = dt.pane_adjacency(w, nn, k)
            err = word_err(got, dt.pane_adjacency_plain(w, nn, k))
            worst = max(worst, err)
            if err:
                raise RuntimeError(f"pane_adjacency {name}{tag}: differs from the twin")
        log(f"  pane_adjacency {name}: bit-equal to the plain twin (n={int(n[0])}, aligned and unaligned)")
    return worst


def phase_dense(dev, rng) -> int:
    import torch

    from gelly_streaming_tpu_torch.ops import dense_triangles as dt

    errs = []

    def check(name, adj_np, expect=None, with_numpy=True):
        adj = torch.from_numpy(adj_np).to(dev)
        bits = dt.pack_bits(adj)
        twin = int(dt.dense_triangles_plain(bits)[0])
        ref = numpy_six_triangles(adj_np) if with_numpy else twin
        if expect is not None and ref != expect:
            raise RuntimeError(f"dense_triangles {name}: reference {ref} != {expect}")
        # the same bits 4 B off alignment take the scalar loads
        flat = torch.empty(bits.numel() + 1, dtype=torch.int32, device=dev)
        shifted = flat[1:].view(bits.shape)
        shifted.copy_(bits)
        for tag, b in (("", bits), (" unaligned", shifted)):
            got = int(dt.dense_triangles(b)[0])
            errs.append(abs(got - twin))
            if not got == twin == ref:
                raise RuntimeError(
                    f"dense_triangles {name}{tag}: kernel {got}, twin {twin}, reference {ref}"
                )
        log(f"  dense_triangles {name}: total {twin} exact "
            f"(twin, {'numpy' if with_numpy else 'twin only'}; aligned and unaligned)")

    for k, p in ((32, 0.4), (96, 0.2), (128, 0.2), (4096, 0.01), (8192, 0.004)):
        upper = np.triu(rng.random((k, k), dtype=np.float32) < p, 1)
        check(f"K={k}", upper | upper.T, with_numpy=k <= 4096)
    kc = 2048
    check("complete K=2048", ~np.eye(kc, dtype=bool), expect=kc * (kc - 1) * (kc - 2))
    check("star K=4096", adjacency(4096, *star_edges(rng, 4096)))
    check("Zipf K=4096, 2^17 edges", adjacency(4096, *zipf_edges(rng, 4096, PANE_EDGES)),
          with_numpy=False)
    for k in (4096, 96):
        u, v = boundary_edges(k)
        m = len(set(u) | set(v))
        check(f"bit 31 / word edges K={k}", adjacency(k, u, v), expect=m * (m - 1) * (m - 2))
    check("empty K=4096", np.zeros((4096, 4096), bool), expect=0, with_numpy=False)
    k = 16384
    src = rng.integers(0, k, 16 * k)
    dst = rng.integers(0, k, 16 * k)
    adj = torch.zeros((k, k), dtype=torch.bool, device=dev)
    s, d = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    adj[s, d] = True
    adj[d, s] = True
    adj.fill_diagonal_(False)
    check("K=16384", adj.cpu().numpy(), with_numpy=False)
    return max(errs)


# ---------------------------------------------------------------------------
# phase 4: the main path


def main_path_stream(rng, dev):
    """(stream, panes) for the main-path run: the stream's windows are the
    panes, in order."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io.sources import _batched

    panes = []
    for _ in range(DENSE_WINDOWS):
        panes.append((rng.integers(0, PANE_VERTICES, PANE_EDGES),
                      rng.integers(0, PANE_VERTICES, PANE_EDGES)))
    panes.append((rng.integers(0, 8192, PANE_EDGES), rng.integers(0, 8192, PANE_EDGES)))
    # sparse ids: 12000 distinct ids spread over [0, 2^16) -> CSR path
    ids = rng.choice(1 << 16, 12000, replace=False)
    panes.append((ids[rng.integers(0, len(ids), 1 << 15)],
                  ids[rng.integers(0, len(ids), 1 << 15)]))
    panes = [(s.astype(np.int32), d.astype(np.int32)) for s, d in panes]
    times = [
        np.sort(rng.integers(w * WINDOW_MS, (w + 1) * WINDOW_MS, len(p[0])))
        for w, p in enumerate(panes)
    ]
    src = np.concatenate([p[0] for p in panes])
    dst = np.concatenate([p[1] for p in panes])
    tim = np.concatenate(times)
    cfg = StreamConfig(vertex_capacity=1 << 16, batch_size=1 << 16)
    stream = EdgeStream.from_batches(
        _batched(src, dst, None, tim, None, cfg.batch_size, dev), cfg, device=dev
    )
    return stream, panes


def plain_pane_count(src, dst, dev) -> int:
    """A pane's count with the plain twins on the card, on compacted ids."""
    from gelly_streaming_tpu_torch.ops import dense_triangles as dt

    verts, inv = np.unique(np.concatenate([src, dst]), return_inverse=True)
    cu, cv = inv[: len(src)], inv[len(src):]
    w, n = dt.pack_pane(cu, cv)
    words, nn = to_dev(dt.packed_host_arrays(w, n), dev)
    bits = dt.pane_adjacency_plain(words, nn, dt.pane_k(len(verts)))
    return int(dt.dense_triangles_plain(bits)[0]) // 6


def check_windows(panes, dev):
    """Both kernels against their twins on every dense window of the main
    path, as the path prepares it: (windows checked, adjacency err, total err)."""
    from gelly_streaming_tpu_torch.io.prefetch import upload
    from gelly_streaming_tpu_torch.library import triangles as tri
    from gelly_streaming_tpu_torch.ops import dense_triangles as dt

    checked, adj_err, tri_err = 0, 0, 0
    for w, (src, dst) in enumerate(panes):
        meta, arrays = tri._pane_prepare((src, dst), dev)
        if meta[0] != "packed":
            continue
        words, nn = upload(arrays, dev)
        k = dt.pane_k(meta[1])
        bits = dt.pane_adjacency(words, nn, k)
        twin_bits = dt.pane_adjacency_plain(words, nn, k)
        twin = int(dt.dense_triangles_plain(twin_bits)[0])
        e_adj = word_err(bits, twin_bits)
        e_tri = max(abs(int(dt.dense_triangles(twin_bits)[0]) - twin),
                    abs(int(dt.pane_triangles(words, nn, k)[0]) - twin))
        if e_adj or e_tri:
            raise RuntimeError(f"window {w} (K={k}): kernels differ from the twins "
                               f"({e_adj}, {e_tri})")
        adj_err, tri_err = max(adj_err, e_adj), max(tri_err, e_tri)
        checked += 1
    return checked, adj_err, tri_err


# ---------------------------------------------------------------------------
# phase 5: the first port slice's kernels, for the in-turn comparison

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
BASELINE_SIGNATURES = {
    "pane_adjacency_launch": [_P, _P, _I, _P, _I, _P],
    "dense_triangles_launch": [_P, _I, _P, _P],
}


def load_baseline(path: str, signatures=None):
    """``path`` built (or its build reused) and loaded, with the entry
    points of ``signatures`` (default: the first slice's pane kernels)."""
    from gelly_streaming_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(_cuda.build_all([path])[path].path))
    for name, argtypes in (signatures or BASELINE_SIGNATURES).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _cuda.RESTYPES.get(name, ctypes.c_int)
    return lib


def baseline_wrappers(lib):
    """The first slice's two wrappers over ``lib``: they zero the outputs
    with ``torch.zeros`` and launch."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda

    def adjacency(words, n, k):
        bits = torch.zeros((k, k // 32), dtype=torch.int32, device=words.device)
        stream = torch.cuda.current_stream(words.device).cuda_stream
        _cuda.check(lib.pane_adjacency_launch(words.data_ptr(), n.data_ptr(),
                                              words.shape[0], bits.data_ptr(), k, stream),
                    "baseline pane_adjacency")
        return bits

    def dense(bits):
        total = torch.zeros((1,), dtype=torch.int64, device=bits.device)
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        _cuda.check(lib.dense_triangles_launch(bits.data_ptr(), bits.shape[0],
                                               total.data_ptr(), stream),
                    "baseline dense_triangles")
        return total

    return adjacency, dense


# ---------------------------------------------------------------------------
# phase 11: the parent commit's degrees.cu and unionfind.cu (before the
# redesign of degree_fold and compress), for the in-turn comparison, and
# the split of its compress

PARENT_SIGNATURES = {
    # (d65530e) deg, src, dst, mask, n, capacity, stream
    "degrees": {"degree_fold_launch": [_P, _P, _P, _P, _I, _I, _P]},
    # (d65530e) items, nodes; parent, seen, src, dst, mask, n, capacity, flat, scratch, scratch bytes, stream
    "unionfind": {"uf_scratch_bytes": [_L, _L],
                  "uf_union_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _L, _P],
                  "uf_parity_union_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _L, _P]},
    # (8ebc8a0) sorted keys, n, buckets, tile table, info, offsets, totals, stream; sorted keys, order
    # (int64), n, buckets, tile table, info, offsets, src, dst, keys out, nbrs out, valid out, stream
    "neighborhoods": {"nb_count_launch": [_P, _I, _I, _P, _P, _P, _P, _P],
                      "nb_scatter_launch": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P]},
    # (8ebc8a0) table, C, F, keys, nbrs, valid, K, D, chunk, chunks, vec, out, partial sums, counts, stream
    "sage": {"sage_gather_mean_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]},
    # (ece4aae, the backward on the CUDA cores) the layer: table, C, F_in, keys, nbrs, valid, K, D, w, bias,
    # F_out, out, chunk, chunks, partial sums, counts, stream; the backward's scratch bytes (F_in, F_out);
    # the backward: table, C, F_in, keys, nbrs, valid, K, D, z, dz, F_out, dw, db, chunk, chunks, partial
    # sums, counts, scratch, scratch bytes, stream
    # (8ff7365, binary search over the radix-sorted CSR) k, e, n_v; u, v, ok, k, e, n_v, shift, rows, cols,
    # mask, stream; meta, n, mask, stream; u, v, ok, k, e, n_v, shift, rows, cols, meta, out, scratch, scratch
    # bytes, stream
    "csr": {"csr_scratch_bytes": [_I, _I, _I],
            "csr_expand_launch": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
            "csr_prefix_mask_launch": [_P, _L, _P, _P],
            "csr_count_launch": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _L, _P]},
    # (5e8e61b, one thread block walking the chunks) nbrs, deg, dropped, local, glob, src, dst, mask, n,
    # capacity, max_degree, chunk, stream; the same with trace_local, trace_global for chunk
    # (9717394, one warp a group of 32 destinations, a hub's in-segment one warp's) n; off, d_off, d_src, n,
    # damping, tol, max_iters, rs [2n], in_window, scratch, its bytes, stream
    "spmv": {"pagerank_scratch_bytes": [_I],
             "pagerank_fixpoint_launch": [_P, _P, _P, _I, _F, _F, _I, _P, _P, _P, _L, _P]},
    # (a48e429, one C call a bucket) c, n, keys, nbrs, valid, k, d, h, stage | None, stream
    "kcore": {"kcore_round_launch": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _P]},
    # (c34004e, the capped pre-filter, then one block resolving every candidate) n, capacity, max_degree, k, cap,
    # body; nbrs, deg, capacity, max_degree, src, dst, mask, n, k, cap, body, scratch, scratch bytes, stats
    # int32[4], stream
    "spanner": {"spanner_scratch_bytes": [_I, _I, _I, _I, _I, _I],
                "spanner_admit_launch": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _L, _P, _P]},
    # (c34004e, the key chain on one thread of the card) n, S; key, edge, third, closed_a, closed_b, edges_seen,
    # seen, S, C, src, dst, mask, n, scratch, scratch bytes, stream
    "sampler": {"sampler_scratch_bytes": [_I, _I],
                "sampler_scan_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _L, _P]},
    # (5030d41, one thread walking the batch) partner, weight, capacity, src, dst, val, mask, n, events, emask,
    # stream
    "matching": {"matching_scan_launch": [_P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P]},
    "exact": {"triangle_block_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
              "triangle_trace_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P]},
    "sage_backward": {
        "sage_layer_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P],
        "sage_layer_backward_scratch_bytes": [_I, _I],
        "sage_layer_backward_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _L,
                                       _P],
    },
}

# The parent's compress_kernel (a cooperative launch: one doubling round and
# one grid-wide sync on a flat state) with one part taken out, for the split
# of its time (phase 7); the form of BACKWARD_SPLIT.
COMPRESS_SPLIT = {
    "the launch alone (the kernel returns at once)": [
        ("compress_kernel(int* __restrict__ parent, int capacity, int* __restrict__ header) {\n",
         "compress_kernel(int* __restrict__ parent, int capacity, int* __restrict__ header) {\n  return;\n")],
    "the launch and one round (no grid-wide sync)": [
        ("    moved_any = round_end(grid, flags, round, moved);", "    moved_any = false;\n    ++round;")],
    "the launch and the sync (a round that reads nothing)": [
        ("    for (int64_t i = first; i < capacity; i += stride) {\n      const int p = load_relaxed(parent + i);",
         "    for (int64_t i = capacity; i < capacity; i += stride) {\n      const int p = load_relaxed(parent + i);")],
}


# The current degree_fold_kernel with one part taken out (the results are
# wrong; only their time counts), for what holds it back (phase 11); the
# form of BACKWARD_SPLIT.
FOLD_SPLIT = {
    "the src half's reductions": [
        ("    run_counts(v, ok, cnt);\n", "    run_counts(v, ok, cnt);\n    cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;\n")],
    "the dst half's reductions": [
        ("    run_counts(v + 4, ok + 4, cnt + 4);\n",
         "    run_counts(v + 4, ok + 4, cnt + 4);\n    cnt[4] = cnt[5] = cnt[6] = cnt[7] = 0;\n")],
    "every reduction (loads and run merging alone)": [
        ("    run_counts(v, ok, cnt);\n", "    run_counts(v, ok, cnt);\n    cnt[0] = cnt[1] = cnt[2] = cnt[3] = 0;\n"),
        ("    run_counts(v + 4, ok + 4, cnt + 4);\n",
         "    run_counts(v + 4, ok + 4, cnt + 4);\n    cnt[4] = cnt[5] = cnt[6] = cnt[7] = 0;\n")],
    "the hot-id cache (no id admitted)": [
        ("        if (lane == leader && __popc(peers) > 1) {", "        if (false) {")],
    "runs across lanes (merged inside a lane only)": [
        ("  cont[0] = lane > 0 && ok[0] && pok && px == x[0];", "  cont[0] = false;")],
}


# The current sage.cu's tensor-core backward with one part taken out or
# changed, for the split of its time (phase 13 (d)); the same form.  A
# variant that does not build is reported and skipped.
BACKWARD_SPLIT = {
    "the product (no wgmma: the accumulators dead)": [
        ("        if (mma) {\n          asm volatile(\"wgmma.fence",
         "        if (false) {\n          asm volatile(\"wgmma.fence")],
    "the tensor work alone (the accumulators live through an empty asm)": [
        ('      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "', '      "// "'),
        ('      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "', '      "// "')],
    "the means' gather (the self rows still copied)": [
        ("gather_tile<8, true, false, kBackBatch>(a, r0, k0, kw, s_a, 0, s_red);",
         "gather_tile<8, true, true>(a, r0, k0, kw, s_a, 0, s_red);")],
    "the z and dz copies": [
        ("          copy_zdz(b, r0, rows, n0, ncols, reinterpret_cast<__nv_bfloat16*>(stage + P::kROff));\n", "")],
    "4 rows in flight a lane in the means' gather (8 instead, the forward's)": [
        ("constexpr int kBackBatch = 4;", "constexpr int kBackBatch = 8;")],
}


def split_sources(source: str, split: dict, stem: str) -> dict:
    """{part removed: path of the variant's source}: ``source`` with each
    entry of ``split`` applied, written under the port's build
    directory."""
    from gelly_streaming_tpu_torch.ops import _cuda

    text = open(source).read()
    out_dir = _cuda.BUILD_DIR / "split"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for k, (part, subs) in enumerate(split.items()):
        variant = text
        for old, new in subs:
            if variant.count(old) != 1:
                raise RuntimeError(f"{stem} split {part!r}: {old[:40]!r} found {variant.count(old)} times")
            variant = variant.replace(old, new)
        path = out_dir / f"{stem}_split_{k}.cu"
        path.write_text(variant)
        paths[part] = str(path)
    return paths


def parent_union_fold(lib, parity: bool):
    """The parent's call (its compress, then the union; compress alone for
    no edges) with its own scratch, as its wrapper made it: fold(parent,
    seen, src, dst, flat=False)."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda

    entry = lib.uf_parity_union_launch if parity else lib.uf_union_launch

    def fold(parent, seen, s, d, flat=False):
        n = d.shape[0]
        nbytes = lib.uf_scratch_bytes(2 * n if parity else n, parent.shape[0])
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=parent.device)
        _cuda.check(entry(parent.data_ptr(), None if seen is None else seen.data_ptr(), s.data_ptr(), d.data_ptr(),
                          None, n, parent.shape[0] // 2 if parity else parent.shape[0], int(flat),
                          scratch.data_ptr(), nbytes, torch.cuda.current_stream(parent.device).cuda_stream),
                    "parent union")
        return parent, seen

    return fold


def parent_degree_fold(lib):
    """The parent's degree_fold call: fold(deg, src, dst)."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda

    def fold(deg, s, d):
        _cuda.check(lib.degree_fold_launch(deg.data_ptr(), s.data_ptr(), d.data_ptr(), None, s.shape[0],
                                           deg.shape[0], torch.cuda.current_stream(deg.device).cuda_stream),
                    "parent degree_fold_launch")
        return deg

    return fold


# ---------------------------------------------------------------------------
# phases 6-7: the union-find kernels and the streaming CC main path


def uf_bound_ms(n_edges: int, capacity: int) -> tuple:
    """Least device time (ms) of each kernel of one fold of n_edges into a
    capacity-C state at the HBM rate: (union kernel, compress kernel).  The
    union kernel reads src/dst (8 B an edge) and parent (4 B a vertex) and
    writes seen (1 B a vertex); the entries it lowers are few on a late
    batch and are counted in compress's row, which reads and writes parent
    (4 B a vertex each way).  The whole call's bound is the sum."""
    union = (8 * n_edges + 5 * capacity) / HBM_BYTES_PER_S * 1e3
    return union, 8 * capacity / HBM_BYTES_PER_S * 1e3


def uf_forest(rng, c: int) -> np.ndarray:
    """A forest over [0, c) whose roots are not the smallest ids of their
    trees: in a random order, 70% of the vertices join under a random
    earlier vertex."""
    order = rng.permutation(c)
    parent = np.arange(c, dtype=np.int32)
    k = np.nonzero(rng.random(c) < 0.7)[0]
    k = k[k > 0]
    parent[order[k]] = order[(rng.random(len(k)) * k).astype(np.int64)]
    return parent


def uf_cases(rng, c: int, n: int):
    """(name, src, dst, mask | None, starting parent) of each adversarial
    fold, at the main path's shapes."""
    ident = np.arange(c, dtype=np.int32)
    mask = np.ones(n, bool)
    mask[n - 3 * n // 8 :] = False
    hub = int(rng.integers(0, c))
    top = np.full(n // 2, c - 1)
    path = np.arange(c - 1)
    order = rng.permutation(c - 1)
    zipf = lambda: (rng.zipf(1.3, n) - 1) % c  # noqa: E731
    loops = rng.integers(0, c, n)
    return [
        ("uniform", rng.integers(0, c, n), rng.integers(0, c, n), None, ident),
        ("star", np.full(c - 1, hub), np.delete(np.arange(c), hub), None, ident),
        ("Zipf", zipf(), zipf(), None, ident),
        (f"{c}-vertex path, reverse order", path[::-1], path[::-1] + 1, None, ident),
        (f"{c}-vertex path, shuffled", order, order + 1, None, ident),
        ("self-loops", loops, loops, None, ident),
        ("masked tail", rng.integers(0, c, n), rng.integers(0, c, n), mask, ident),
        ("ids at capacity - 1", np.concatenate([top, rng.integers(0, c, n // 2)]),
         np.concatenate([rng.integers(0, c, n // 2), top]), None, ident),
        ("non-minimum-root forest", rng.integers(0, c, n), rng.integers(0, c, n), None, uf_forest(rng, c)),
        ("ids -1, C and C + 5 (JAX's index rules)", oor_ids(rng.integers(0, c, n), c),
         oor_ids(rng.integers(0, c, n), c, 5), None, ident),
    ]


def oor_ids(ids, c: int, shift: int = 0):
    """``ids`` with a spread of rows set to -1, C and C + 5 (what an
    unvalidated stream may carry; JAX's gather and scatter rules apply)."""
    ids = np.array(ids, dtype=np.int64)
    for k, x in enumerate((-1, c, c + 5)):
        ids[shift + k :: 997] = x
    return ids


def phase_union(dev, rng):
    """The union kernel against its twin on every adversarial case; returns
    (max |parent err| + |seen err|, per-case kernel ms)."""
    import torch

    from gelly_streaming_tpu_torch.ops import unionfind as uf

    c, n = CC_VERTICES, CC_BATCH
    uf.compress(uf.init_parent(16, dev))  # load the library outside the timed calls
    worst = 0
    for name, u, v, m, parent0 in uf_cases(rng, c, n):
        s, d = to_dev((np.ascontiguousarray(u, np.int32), np.ascontiguousarray(v, np.int32)), dev)
        mask = None if m is None else to_dev((m,), dev)[0]
        p0 = torch.from_numpy(parent0).to(dev)
        seen0 = torch.zeros(c, dtype=torch.bool, device=dev)
        want = {}
        twin_ms = cuda_ms(lambda: want.update(r=uf.union_edges_with_seen_plain(p0, seen0, s, d, mask)), 1, 0)
        p, sn = p0.clone(), seen0.clone()
        kern_ms = cuda_ms(lambda: uf.union_edges_with_seen(p, sn, s, d, mask), 1, 0)
        err = int((p.long() - want["r"][0].long()).abs().max()) + int((sn != want["r"][1]).sum())
        worst = max(worst, err)
        if err:
            raise RuntimeError(f"union kernel {name}: differs from the twin ({err})")
        log(f"  union {name}: {len(u)} edges, parent and seen equal to the twin; kernel "
            f"{kern_ms:.4f} ms, twin {twin_ms:.3f} ms, {len(torch.unique(p))} roots")
    a0 = torch.from_numpy(uf_forest(rng, c)).to(dev)
    b0 = torch.from_numpy(uf_forest(rng, c)).to(dev)
    want = uf.merge_parents_plain(a0, b0)
    a = a0.clone()
    kern_ms = cuda_ms(lambda: uf.merge_parents(a, b0), 1, 0)
    err = int((a.long() - want.long()).abs().max())
    worst = max(worst, err)
    if err:
        raise RuntimeError("merge_parents kernel differs from the twin")
    log(f"  merge_parents of two non-minimum-root forests: equal to the twin; kernel {kern_ms:.4f} ms")
    return worst


def copies_device_ms(call, make_copy, reps: int, cycles_per_ms: float):
    """(device ms, host enqueue us) per ``call(copy)``, each call on its own
    ``make_copy()`` (made before the hold), the calls enqueued while
    ``torch.cuda._sleep`` holds the stream."""
    import torch

    hold_ms = 2.0
    for _ in range(4):
        copies = [make_copy() for _ in range(reps)]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        start.record()
        t0 = time.perf_counter()
        for cp in copies:
            call(cp)
        host_s = time.perf_counter() - t0
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps, host_s / reps * 1e6
        hold_ms *= 4
    raise RuntimeError("the host could not enqueue the timed calls inside the hold")


def fold_device_ms(fold, parent, seen, s, d, reps: int, cycles_per_ms: float, flat: bool = False):
    """(device ms, host enqueue us) per ``fold(parent, seen, s, d)`` call,
    each call folding (s, d) into its own fresh copy of (parent, seen).
    ``flat``: the copies are marked flat, as the state a fold left is on
    the main path (the port's fold then skips compress)."""
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    return copies_device_ms(lambda cp: fold(*cp, s, d),
                            lambda: ((uf.mark_flat(parent.clone()) if flat else parent.clone()), seen.clone()),
                            reps, cycles_per_ms)


def union_kernel_profile(parent, seen, s, d, reps: int, fold=None):
    """torch.profiler device us per launch of the union kernel, the compress
    pass and the compress rounds kernel over ``reps`` calls of ``fold``
    (default the CC fold) into fresh state copies: {kernel: us}."""
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    fold = fold or uf.union_edges_with_seen
    copies = iter([(parent.clone(), seen.clone()) for _ in range(reps + 1)])
    rows = profiler_device_us(lambda: fold(*next(copies), s, d), reps)
    found = {}
    for key, (us, _calls) in rows.items():
        for kernel in ("union_kernel", "compress_kernel", "compress_rounds_kernel"):
            if re.search(rf"\b{kernel}[<(]", key):
                found[kernel] = us
    return found


def cc_oracle(src, dst, capacity: int):
    """(parent, seen) the CC fold must reach, by scipy: every vertex labelled
    with the smallest id of its component; seen = touched by an edge."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    g = coo_matrix((np.ones(len(src), np.int32), (src, dst)), shape=(capacity, capacity)).tocsr()
    _, labels = connected_components(g, directed=False)
    smallest = np.full(labels.max() + 1, capacity, np.int64)
    np.minimum.at(smallest, labels, np.arange(capacity))
    seen = np.zeros(capacity, bool)
    seen[src] = True
    seen[dst] = True
    return smallest[labels].astype(np.int32), seen


def pack_batches(src, dst, batch: int, width) -> list:
    """Wire buffers of every whole batch, packed by ``io.wire.pack_edges``
    on a pool of host threads (numpy's sorts and copies release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from gelly_streaming_tpu_torch.io import wire

    def one(i):
        return wire.pack_edges(src[i * batch : (i + 1) * batch], dst[i * batch : (i + 1) * batch], width)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(one, range(len(src) // batch)))


def cc_bench_stream() -> dict:
    """The CC bench's stream (bench.py:2190-2192): 50 batches of 2^21
    uniform edges over 2^20 vertices from numpy's default_rng(0), packed
    at ``replay_width`` (EF40) for the wire replay.  Phases 7-10 share it."""
    from gelly_streaming_tpu_torch.io import wire

    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    rng = np.random.default_rng(0)
    src = rng.integers(0, c, nb * batch).astype(np.int32)
    dst = rng.integers(0, c, nb * batch).astype(np.int32)
    width = wire.replay_width(c, batch)
    t0 = time.perf_counter()
    bufs = pack_batches(src, dst, batch, width)
    return {"src": src, "dst": dst, "width": width, "bufs": bufs, "pack_s": time.perf_counter() - t0}


def ef40_once_a_batch(label: str, nb: int) -> None:
    """Raise unless the run since the last ``wire_decode.reset_launches()``
    launched ``ef40_unpack`` once a batch and never ran its twin."""
    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    if wd.LAUNCHES["ef40_unpack"] != nb or wd.TWIN_CALLS["ef40_unpack"]:
        raise RuntimeError(f"{label}: ef40_unpack must launch once a batch ({nb}) and its twin never: "
                           f"{wd.LAUNCHES}, twins {wd.TWIN_CALLS}")


def ef40_bound_ms(n: int, capacity: int) -> float:
    """The EF40 unpack's bytes bound: the bitvector and the pairs read
    once, src and dst written once."""
    return ((n + capacity + 7) // 8 + 5 * ((n + 1) // 2) + 8 * n) / HBM_BYTES_PER_S * 1e3


def phase_cc_main(dev, cycles_per_ms: float, data: dict) -> dict:
    """The streaming CC main path at bench.py's size, checked against the
    twin and scipy; returns the numbers for the report."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.io.prefetch import upload
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents
    from gelly_streaming_tpu_torch.ops import unionfind as uf
    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    num_edges = nb * batch
    src, dst, width, bufs = data["src"], data["dst"], data["width"], data["bufs"]
    wire_bytes = sum(b.nbytes for b in bufs)
    log(f"  {nb} batches of {batch} edges over {c} vertices, width {width}: {wire_bytes / num_edges:.4f} "
        f"wire B/edge, packed in {data['pack_s']:.1f} s (host numpy threads, untimed)")
    cfg = StreamConfig(vertex_capacity=c, batch_size=batch)
    agg = ConnectedComponents()
    # warm the path (allocator, pinned pool, the library's first load)
    EdgeStream.from_wire(bufs[:1], batch, width, cfg, device=dev).aggregate(agg).collect()
    torch.cuda.synchronize()
    stream = EdgeStream.from_wire(bufs, batch, width, cfg, device=dev)
    if not agg._wire_eligible(stream):
        raise RuntimeError("the main path must ride the wire path")

    uf.reset_launches()
    wd.reset_launches()
    t0 = time.perf_counter()
    records = stream.aggregate(agg).collect()
    ds = records[-1][0]
    parent, seen = ds.parent.cpu().numpy(), ds.seen.cpu().numpy()
    wall_s = time.perf_counter() - t0
    launches = dict(uf.LAUNCHES)
    if len(records) != 1:
        raise RuntimeError(f"expected one end-of-stream record, got {len(records)}")
    # the first batch compresses the fresh state; every later one finds it
    # known flat
    if launches["union_kernel"] != nb or launches["compress_kernel"] != 1:
        raise RuntimeError(f"the union-find kernels were not launched once a batch: {launches}")
    ef40_once_a_batch("phase 7", nb)
    launches["ef40_unpack"] = wd.LAUNCHES["ef40_unpack"]
    log(f"  from_wire(...).aggregate(ConnectedComponents()): {wall_s:.3f} s first buffer -> host "
        f"labels, {num_edges / wall_s:.6g} edges/s end to end")
    log(f"  launches on the main path: {launches}")

    # upload alone: the same buffers through the path's pinned H2D copies
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in bufs:
        upload((b,), dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    log(f"  upload alone: {wire_bytes / upload_s / 1e9:.3f} GB/s ({wire_bytes} B in {upload_s:.3f} s)")

    # reference 1: the plain twin folding the same batches (host-decoded)
    # on the card; its states at the emission points and before the last
    # batch are kept
    t_parent = uf.init_parent(c, dev)
    t_seen = torch.zeros(c, dtype=torch.bool, device=dev)
    snaps = {}
    t0 = time.perf_counter()
    for i, b in enumerate(bufs):
        if i == nb - 1:
            snaps["late"] = (t_parent.clone(), t_seen.clone())
        s, d = to_dev(wire.unpack_edges_host(b, batch, width), dev)
        t_parent, t_seen = uf.union_edges_with_seen_plain(t_parent, t_seen, s, d)
        if (i + 1) % CC_EMIT_EVERY == 0 and i + 1 <= CC_EMIT_BATCHES:
            snaps[i + 1] = (t_parent.clone(), t_seen.clone())
    torch.cuda.synchronize()
    twin_fold_s = time.perf_counter() - t0
    err = int(np.abs(parent.astype(np.int64) - t_parent.cpu().numpy()).max())
    err += int((seen != t_seen.cpu().numpy()).sum())
    if err:
        raise RuntimeError(f"final labels differ from the twin's fold ({err})")
    # reference 2: scipy, independent of both
    t0 = time.perf_counter()
    o_parent, o_seen = cc_oracle(src, dst, c)
    data["oracle"] = (o_parent, o_seen)  # phase 19 holds its runs against it
    data["labels"] = (parent, seen)  # phase 21 holds the mesh plane's labels against them
    oracle_s = time.perf_counter() - t0
    if not (np.array_equal(parent, o_parent) and np.array_equal(seen, o_seen)):
        raise RuntimeError("final labels differ from scipy's connected components")
    n_comp = len(np.unique(parent[seen]))
    log(f"  final labels exact: equal to the twin's fold on the card ({twin_fold_s:.1f} s) and to "
        f"scipy ({oracle_s:.1f} s); {int(seen.sum())} seen vertices in {n_comp} components")

    # running emissions: a from_arrays prefix, packed on the path's thread
    k = CC_EMIT_BATCHES * batch
    ecfg = StreamConfig(vertex_capacity=c, batch_size=batch, ingest_window_edges=CC_EMIT_EVERY * batch)
    estream = EdgeStream.from_arrays(src[:k], dst[:k], ecfg, device=dev)
    if not agg._wire_eligible(estream):
        raise RuntimeError("the running-emission stream must ride the wire path")
    emitted = estream.aggregate(agg).collect()
    if len(emitted) != CC_EMIT_BATCHES // CC_EMIT_EVERY:
        raise RuntimeError(f"expected {CC_EMIT_BATCHES // CC_EMIT_EVERY} emissions, got {len(emitted)}")
    for j, (rec,) in enumerate(emitted):
        want_p, want_s = snaps[(j + 1) * CC_EMIT_EVERY]
        if not (torch.equal(rec.parent, want_p) and torch.equal(rec.seen, want_s)):
            raise RuntimeError(f"running emission {j} differs from the twin's fold")
    log(f"  from_arrays + ingest_window_edges={ecfg.ingest_window_edges}: {len(emitted)} running emissions, each equal "
        f"to the twin's fold of its prefix (width {agg._wire_width(ecfg, batch)})")

    # device time of one batch's fold, first and late
    s0, d0 = wire.unpack_edges(to_dev((bufs[0],), dev)[0], batch, width)
    sl, dl = wire.unpack_edges(to_dev((bufs[-1],), dev)[0], batch, width)
    init = (uf.init_parent(c, dev), torch.zeros(c, dtype=torch.bool, device=dev))
    late = snaps["late"]
    fold = uf.union_edges_with_seen
    # the main path's calls: the first batch on a fresh state (compress, then
    # the union), a late one on a state the last fold left flat (the union)
    first_ms, first_us = fold_device_ms(fold, *init, s0, d0, UF_REPS, cycles_per_ms)
    late_ms, late_us = fold_device_ms(fold, *late, sl, dl, UF_REPS, cycles_per_ms, flat=True)
    rounds = {}
    for name, (p0, sn0), (s_, d_), flat in (("first", init, (s0, d0), False), ("late", late, (sl, dl), True)):
        p1 = uf.mark_flat(p0.clone()) if flat else p0.clone()
        fold(p1, sn0.clone(), s_, d_)
        rounds[name] = uf.last_rounds()
    log(f"  the union call's rounds: first batch {rounds['first']}, late batch {rounds['late']}")
    twin_first_ms = cuda_ms(lambda: uf.union_edges_with_seen_plain(*init, s0, d0), 1, 0)
    twin_late_ms = cuda_ms(lambda: uf.union_edges_with_seen_plain(*late, sl, dl), 1, 0)
    compress_twin_ms = cuda_ms(lambda: uf.compress_plain(late[0]), 1, 0)
    # each kernel's held-stream time: the call with no edges is compress
    # alone, and the union kernel is the rest of the call
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    comp_ms, comp_us = fold_device_ms(fold, *late, none, none, UF_REPS, cycles_per_ms)
    held = {"union_kernel": (late_ms, late_us), "compress_kernel": (comp_ms, comp_us)}
    per_kernel, split_by = {}, "torch.profiler"
    try:
        per_kernel = union_kernel_profile(*late, sl, dl, 10)
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")
    if len(per_kernel) < 2:
        per_kernel = {k: ms * 1e3 for k, (ms, _) in held.items()}
        split_by = "held-stream times (the profiler showed no kernel rows)"
    # the call with no edges by kernel: the compress pass, then the rounds
    # kernel (which returns at once where the pass flagged nothing)
    comp_parts = {}
    try:
        comp_parts = union_kernel_profile(*late, none, none, 10)
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")
    log("  compress alone by kernel (torch.profiler, us a launch): "
        + ", ".join(f"{k} {us:.2f}" for k, us in sorted(comp_parts.items())))
    buf_dev = to_dev((bufs[-1],), dev)[0]
    got = wd.unpack_edges_ef40(buf_dev, batch, c)
    want = wd.unpack_edges_ef40_plain(buf_dev, batch, c)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError("ef40_unpack differs from its twin on the stream's last batch")
    unpack_ms, unpack_us = device_ms(lambda: wire.unpack_edges(buf_dev, batch, width), UF_REPS, cycles_per_ms)
    unpack_events_ms = cuda_ms(lambda: wd.unpack_edges_ef40(buf_dev, batch, c), UF_REPS)
    unpack_twin_ms = cuda_ms(lambda: wd.unpack_edges_ef40_plain(buf_dev, batch, c), 10)
    unpack_bound = ef40_bound_ms(batch, c)
    b_union, b_compress = uf_bound_ms(batch, c)
    share = (first_ms + (nb - 1) * late_ms) / (wall_s * 1e3)
    busy = share + nb * unpack_ms / (wall_s * 1e3)
    log(f"  one batch's fold (uf_union_launch), device only: first batch (compress + union) "
        f"{first_ms:.4f} ms, late batch (union, the state known flat) {late_ms:.4f} ms; host enqueue "
        f"{first_us:.2f} / {late_us:.2f} us; bounds {b_union + b_compress:.5f} / {b_union:.5f} ms (bytes)")
    log(f"  per kernel on the late batch, by {split_by}: union_kernel "
        f"{per_kernel['union_kernel']:.2f} us, compress_kernel {per_kernel['compress_kernel']:.2f} us a launch; "
        f"held stream: compress alone (a call with no edges) {comp_ms * 1e3:.2f} us; bounds "
        f"{b_union * 1e3:.3f} / {b_compress * 1e3:.3f} us")
    log(f"  plain twin: first batch {twin_first_ms:.3f} ms, late batch {twin_late_ms:.3f} ms, "
        f"compress_plain {compress_twin_ms:.3f} ms (host loop, syncs included)")
    log(f"  the kernels' share of the wall time: {share * 100:.2f}% (the first batch's fold + "
        f"{nb - 1} x the late batch's, over the wall time)")
    log(f"  EF40 unpack (ef40_unpack) a batch: device {unpack_ms:.5f} ms held, host enqueue {unpack_us:.1f} us, "
        f"events {unpack_events_ms:.5f} ms; bound {unpack_bound:.5f} ms (bytes: the bitvector and pairs read once, "
        f"8 B an edge written), {unpack_ms / unpack_bound:.2f}x; the twin {unpack_twin_ms:.4f} ms; equal to the twin "
        f"on the last batch; launches {launches['ef40_unpack']}; device busy (unpack + fold) ~{busy * 100:.1f}% of "
        f"the wall time, idle ~{(1 - busy) * 100:.1f}%")
    return {
        "ef40": {"launches": launches["ef40_unpack"], "err": 0, "ms": unpack_events_ms, "device_ms": unpack_ms,
                 "host_us": unpack_us, "plain_ms": unpack_twin_ms, "bound_ms": unpack_bound,
                 "ratio": unpack_ms / unpack_bound},
        "launches": launches,
        "first_ms": first_ms,
        "late_ms": late_ms,
        "rounds": rounds,
        "turns": {"init": init, "late": late, "first_batch": (s0, d0), "late_batch": (sl, dl)},
        "union_ms": per_kernel["union_kernel"] / 1e3,
        "compress_ms": per_kernel["compress_kernel"] / 1e3,
        "compress_parts_us": comp_parts,
        "held": held,
        "union_plain_ms": twin_late_ms,
        "compress_plain_ms": compress_twin_ms,
        "union_bound_ms": b_union,
        "compress_bound_ms": b_compress,
    }


def compress_split(dev, cycles_per_ms: float, parent_lib, split_libs: dict) -> dict:
    """Phase 7 with the parent's unionfind.cu: its compress call (a call with
    no edges) on the flat 2^20-vertex state the main path's first batch
    finds (init_parent), split: the header memset alone (the call with the
    state declared flat), then variants of its kernel with one part taken
    out (COMPRESS_SPLIT).  Device ms on the held stream; the parts are
    differences of those calls."""
    import torch

    from gelly_streaming_tpu_torch.ops import unionfind as uf

    state = uf.init_parent(CC_VERTICES, dev)
    none = torch.zeros(0, dtype=torch.int32, device=dev)

    def call_ms(lib, flat=False):
        fold = parent_union_fold(lib, False)
        fold(state.clone(), None, none, none, flat)
        return copies_device_ms(lambda p: fold(p, None, none, none, flat), state.clone, UF_REPS, cycles_per_ms)[0]

    memset = call_ms(parent_lib, flat=True)
    whole = call_ms(parent_lib)
    variants = {part: call_ms(lib) for part, lib in split_libs.items()}
    launch, one_round, sync = (variants.get(k) for k in COMPRESS_SPLIT)
    parts = {"memset_ms": memset, "call_ms": whole, "variants_ms": variants}
    if None not in (launch, one_round, sync):
        parts.update(launch_ms=launch - memset, round_ms=one_round - launch, sync_ms=sync - launch)
    log(f"  the parent's compress call on the flat {CC_VERTICES}-vertex state: {whole * 1e3:.2f} us; header memset "
        f"alone {memset * 1e3:.2f} us; " + "; ".join(f"{k}: {v * 1e3:.2f} us" for k, v in variants.items()))
    if "launch_ms" in parts:
        log(f"    split: memset {memset * 1e3:.2f}, cooperative launch {parts['launch_ms'] * 1e3:.2f}, one round "
            f"{parts['round_ms'] * 1e3:.2f}, one grid-wide sync {parts['sync_ms'] * 1e3:.2f}, rest "
            f"{(whole - one_round - sync + launch) * 1e3:.2f} us")
    return parts


# ---------------------------------------------------------------------------
# phases 8-10: the GraphStream surface, the degree kernels and the parity union


def trace_launcher(counts, v, m):
    """A callable making one raw ``degree_trace_launch`` (packed records)
    over pre-sorted keys: the two kernels alone, without the sort."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda

    lib = _cuda.library("degrees.cu")
    keys, order = torch.sort((v << 1) | (~m).to(torch.int32), stable=True)
    n = v.shape[0]
    rec = torch.empty(6 * n, dtype=torch.uint8, device=v.device)
    bits = torch.empty((n + 7) // 8, dtype=torch.uint8, device=v.device)
    nbytes = lib.degree_trace_scratch_bytes(n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream

    def launch():
        _cuda.check(lib.degree_trace_launch(v.data_ptr(), m.data_ptr(), keys.data_ptr(), order.data_ptr(), n,
                                            counts.data_ptr(), counts.shape[0], rec.data_ptr(), bits.data_ptr(),
                                            None, scratch.data_ptr(), nbytes, stream),
                    "degree_trace_launch")
        return rec, bits

    return launch


def block_columns(out, limit=None):
    """The concatenated columns of an OutputStream's record blocks."""
    cols = None
    for k, blk in enumerate(out.blocks()):
        if limit is not None and k >= limit:
            break
        arrs = [c for c in blk.columns if isinstance(c, np.ndarray)]
        cols = [[a] for a in arrs] if cols is None else [cs + [a] for cs, a in zip(cols, arrs)]
    return [np.concatenate(cs) for cs in cols]


def phase_properties(dev, cycles_per_ms: float, data: dict) -> dict:
    """Phase 8: the degree property stream over the CC bench's 104,857,600
    edges (209,715,200 records, downloaded packed), checked against
    np.bincount and, on its first batches, the twin; the other property
    streams and ``undirected().distinct()`` on prefixes, checked against
    numpy."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream, _interleave_endpoints
    from gelly_streaming_tpu_torch.core.types import EdgeBatch
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.ops import degrees

    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    src, dst = data["src"], data["dst"]
    cfg = StreamConfig(vertex_capacity=c, batch_size=batch)
    # warm the path (the library's first load, the pinned pool)
    EdgeStream.from_arrays(src[:batch], dst[:batch], cfg, device=dev).get_degrees().collect_last()
    torch.cuda.synchronize()

    final = np.zeros(c, np.int64)
    first_blocks, records, check_s = [], 0, 0.0
    degrees.reset_launches()
    t0 = time.perf_counter()
    for k, blk in enumerate(EdgeStream.from_arrays(src, dst, cfg, device=dev).get_degrees().blocks()):
        t_check = time.perf_counter()
        ids, vals = blk.columns
        np.maximum.at(final, ids, vals)
        records += len(ids)
        if k < PROP_TWIN_BATCHES:
            first_blocks.append((ids.copy(), vals.copy()))
        check_s += time.perf_counter() - t_check
    # the stream's own time: the smoke's checks run inside the loop
    wall_s = time.perf_counter() - t0 - check_s
    launches = degrees.LAUNCHES["degree_trace"]
    want = np.bincount(src, minlength=c) + np.bincount(dst, minlength=c)
    if launches != nb:
        raise RuntimeError(f"degree_trace launched {launches} times for {nb} batches")
    if records != 2 * nb * batch or not np.array_equal(final, want):
        raise RuntimeError("the degree trace's final degrees differ from np.bincount")
    down_bytes = nb * (6 * 2 * batch + (2 * batch + 7) // 8)
    log(f"  get_degrees over {nb * batch} edges: {records} records in {wall_s:.3f} s (the smoke's checks, "
        f"{check_s:.3f} s more, excluded), "
        f"{nb * batch / wall_s:.6g} edges/s, {records / wall_s:.6g} records/s, "
        f"{down_bytes / wall_s / 1e9:.3f} GB/s of packed records downloaded; every vertex's final "
        f"degree equal to np.bincount; degree_trace launched {launches} times")

    # the first batches' records against the twin on the card
    counts = torch.zeros(c, dtype=torch.int32, device=dev)
    worst = 0
    for k, (ids, vals) in enumerate(first_blocks):
        b = EdgeBatch.from_arrays(src[k * batch : (k + 1) * batch], dst[k * batch : (k + 1) * batch], device=dev)
        v, m = _interleave_endpoints(b)
        counts, (rec, bits) = degrees.degree_trace_plain(counts, v, m, True)
        w_ids, w_vals, w_m = wire.unpack_records48(rec.cpu().numpy(), bits.cpu().numpy(), len(v))
        if len(ids) != int(w_m.sum()):
            raise RuntimeError(f"batch {k}: {len(ids)} records, the twin {int(w_m.sum())}")
        worst = max(worst, int(np.abs(ids - w_ids[w_m]).max()), int(np.abs(vals - w_vals[w_m]).max()))
    if worst:
        raise RuntimeError(f"the degree trace differs from the twin on its first batches ({worst})")
    log(f"  the first {len(first_blocks)} batches' trace equal to the twin's, record for record")

    # times at the main path's shapes: the last batch, unpacked on the card
    bs, bd = src[-batch:], dst[-batch:]
    buf = torch.from_numpy(wire.pack_edges(bs, bd, wire.PAIR40)).to(dev)
    s, d = wire.unpack_edges(buf, batch, wire.PAIR40)
    v, m = _interleave_endpoints(EdgeBatch(src=s, dst=d, mask=torch.ones(batch, dtype=torch.bool, device=dev)))
    counts = torch.zeros(c, dtype=torch.int32, device=dev)
    launch = trace_launcher(counts, v, m)
    k_ms, k_us = device_ms(launch, UF_REPS, cycles_per_ms)
    k_events = cuda_ms(launch, UF_REPS)
    call_ms, call_us = device_ms(lambda: degrees.degree_trace(counts, v, m, True), UF_REPS, cycles_per_ms)

    def step():
        s2, d2 = wire.unpack_edges(buf, batch, wire.PAIR40)
        v2, m2 = _interleave_endpoints(EdgeBatch(src=s2, dst=d2, mask=m[:batch]))
        return degrees.degree_trace(counts, v2, m2, True)

    step_ms, step_us = device_ms(step, UF_REPS, cycles_per_ms)
    plain_ms = cuda_ms(lambda: degrees.degree_trace_plain(counts, v, m, True), 3, 1)
    n = 2 * batch
    # the kernel's own inputs: sorted keys + order read (12 B a row), the
    # mask read (1 B), record + mask bit written (6 + 1/8 B), counts read and
    # written once a vertex this batch touches (8 B)
    touched = int(torch.unique(v).numel())
    bound = (12 * n + n + 6 * n + n / 8 + 8 * touched) / HBM_BYTES_PER_S * 1e3
    rec_dev = torch.empty(6 * n + (n + 7) // 8, dtype=torch.uint8, device=dev)
    host = torch.empty(rec_dev.shape, dtype=torch.uint8, pin_memory=True)
    d2h_ms = cuda_ms(lambda: host.copy_(rec_dev, non_blocking=True), 10)
    rec_h, bits_h = (t.cpu().numpy() for t in degrees.degree_trace(counts, v, m, True))
    t0 = time.perf_counter()
    for _ in range(3):
        wire.unpack_records48(rec_h, bits_h, n)
    decode_ms = (time.perf_counter() - t0) / 3 * 1e3
    busy = nb * step_ms / (wall_s * 1e3)
    log(f"  degree_trace kernels alone (after the sort), device only: {k_ms:.4f} ms a batch of {n} rows, "
        f"host enqueue {k_us:.2f} us, back-to-back events {k_events:.4f} ms; bound {bound:.5f} ms (bytes, "
        f"{touched} vertices touched)")
    try:
        split = {(re.search(r"(\w+)\(", key) or re.search(r"(.*)", key)).group(1): round(us, 2)
                 for key, (us, _) in profiler_device_us(launch, 10).items()}
        log(f"  degree_trace by torch.profiler, us a launch: {split}")
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")
    log(f"  degree_trace call (keys, torch.sort, kernel): device {call_ms:.4f} ms, host enqueue {call_us:.1f} us; "
        f"the whole batch step (PAIR40 unpack, interleave, call): device {step_ms:.4f} ms, host {step_us:.1f} us")
    log(f"  plain twin {plain_ms:.3f} ms; one batch's packed records D2H alone {d2h_ms:.4f} ms "
        f"({rec_dev.numel() / d2h_ms / 1e6:.3f} GB/s)")
    log(f"  host decode of one batch's records (numpy unpack_records48): {decode_ms:.2f} ms, "
        f"{nb * decode_ms / (wall_s * 1e3) * 100:.1f}% of the wall time over {nb} batches")
    log(f"  device busy ~{busy * 100:.2f}% of the get_degrees wall time, idle ~{(1 - busy) * 100:.2f}%")

    # the kernels against the twin at the main path's shape, with ids -1, C
    # and C + 5 on some rows (JAX's index rules), packed and raw
    v_oor = torch.from_numpy(oor_ids(v.cpu().numpy(), c).astype(np.int32)).to(dev)
    m_oor = m.clone()
    m_oor[1::7] = False
    c0 = torch.from_numpy(np.random.default_rng(8).integers(0, 1 << 10, c).astype(np.int32)).to(dev)
    for packed in (True, False):
        got_c = c0.clone()
        got = degrees.degree_trace(got_c, v_oor, m_oor, packed)
        want_c, want = degrees.degree_trace_plain(c0, v_oor, m_oor, packed)
        oor_err = int((got_c - want_c).abs().max()) + sum(int((g.long() - w.long()).abs().max())
                                                          for g, w in zip(got, want))
        if oor_err:
            raise RuntimeError(f"degree_trace with out-of-range ids differs from the twin ({oor_err}, packed {packed})")
        worst = max(worst, oor_err)
    log(f"  degree_trace with ids -1, C, C + 5 on every 997th row and a mask: counts and records equal to the "
        f"twin's (packed and raw), {n} rows")

    # the other property streams over a prefix of 8 batches
    k = PROP_PREFIX_BATCHES * batch
    ps, pd = src[:k], dst[:k]
    stream = EdgeStream.from_arrays(ps, pd, cfg, device=dev)
    inter = np.stack([ps, pd], axis=1).reshape(-1)
    _, first_idx = np.unique(inter, return_index=True)
    order_v = inter[np.sort(first_idx)]
    t0 = time.perf_counter()
    ids, vals = block_columns(stream.get_in_degrees())
    fin = np.zeros(c, np.int64)
    np.maximum.at(fin, ids, vals)
    if len(ids) != k or not np.array_equal(fin, np.bincount(pd, minlength=c)):
        raise RuntimeError("get_in_degrees differs from np.bincount")
    (nv,) = block_columns(stream.number_of_vertices())
    if not np.array_equal(nv, np.arange(1, len(order_v) + 1)):
        raise RuntimeError("number_of_vertices differs from numpy")
    (ne,) = block_columns(stream.number_of_edges())
    if not np.array_equal(ne, np.arange(1, k + 1)):
        raise RuntimeError("number_of_edges differs from numpy")
    (gv,) = block_columns(stream.get_vertices())
    if not np.array_equal(gv, order_v):
        raise RuntimeError("get_vertices differs from numpy's first appearances")
    log(f"  get_in_degrees, number_of_vertices, number_of_edges, get_vertices over {PROP_PREFIX_BATCHES} "
        f"batches: equal to numpy ({len(order_v)} vertices) in {time.perf_counter() - t0:.1f} s")

    # undirected().distinct() over 2 batches against a numpy set
    k = PROP_DISTINCT_BATCHES * batch
    t0 = time.perf_counter()
    got = []
    for b in EdgeStream.from_arrays(src[:k], dst[:k], cfg, device=dev).undirected().distinct().batches():
        keep = b.mask.cpu().numpy()
        got.append(b.src.cpu().numpy()[keep].astype(np.int64) * c + b.dst.cpu().numpy()[keep])
    got = np.concatenate(got)
    seq = []
    for i in range(PROP_DISTINCT_BATCHES):
        s_i, d_i = src[i * batch : (i + 1) * batch].astype(np.int64), dst[i * batch : (i + 1) * batch].astype(np.int64)
        seq += [s_i * c + d_i, d_i * c + s_i]
    seq = np.concatenate(seq)
    _, first_idx = np.unique(seq, return_index=True)
    if not np.array_equal(got, seq[np.sort(first_idx)]):
        raise RuntimeError("undirected().distinct() differs from numpy's first occurrences")
    log(f"  undirected().distinct() over {PROP_DISTINCT_BATCHES} batches: {len(got)} distinct directed edges "
        f"of {len(seq)}, equal to numpy's first occurrences, in {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "ms": k_events, "device_ms": k_ms, "host_us": k_us, "plain_ms": plain_ms,
            "bound_ms": bound, "err": worst, "call_ms": call_ms, "turns": (v, m)}


def degree_dist_oracle(src, dst, sign):
    """The reference's three keyed stages (DegreeDistribution.java:70-132)
    as host dicts, event by event: (degree, count) records."""
    degs, hist, out = {}, {}, []
    for u, v, g in zip(src.tolist(), dst.tolist(), sign.tolist()):
        for x in (u, v):
            old = degs.get(x, 0)
            if g < 0 and old <= 0:
                continue  # deleting an absent vertex
            new = old + g
            if new > 0:
                degs[x] = new
                hist[new] = hist.get(new, 0) + 1
                out.append((new, hist[new]))
            else:
                degs.pop(x, None)
            if old > 0:
                hist[old] -= 1
                out.append((old, hist[old]))
    return out


def signed_events(rng, n: int, vertices: int, hubs: int = 0):
    """Signed events, about 30% deletions (some of absent vertices), a few
    self-loops, and with ``hubs`` a quarter of the rows on ``hubs`` vertices."""
    src = rng.integers(0, vertices, n).astype(np.int32)
    dst = rng.integers(0, vertices, n).astype(np.int32)
    dst[::97] = src[::97]
    if hubs:
        sel = rng.random(n) < 0.25
        src[sel] = rng.integers(0, hubs, int(sel.sum()))
    sign = np.where(rng.random(n) < 0.3, -1, 1).astype(np.int8)
    return src, dst, sign


def signed_stream(src, dst, sign, cfg, batch: int, dev):
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io.sources import _batched

    return EdgeStream.from_batches(_batched(src, dst, None, None, sign, batch, dev), cfg, device=dev)


def phase_degree_dist(dev, cycles_per_ms: float, data: dict) -> dict:
    """Phase 9: DegreeDistributionSummary over the EF40 replay (degree_fold)
    and DegreeDistribution over signed streams (degree_dist_scan)."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.library.degree_distribution import DegreeDistribution, DegreeDistributionSummary
    from gelly_streaming_tpu_torch.ops import _cuda, degrees, wire_decode

    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    src, dst, width, bufs = data["src"], data["dst"], data["width"], data["bufs"]
    cfg = StreamConfig(vertex_capacity=c, batch_size=batch)
    agg = DegreeDistributionSummary()
    EdgeStream.from_wire(bufs[:1], batch, width, cfg, device=dev).aggregate(agg).collect()
    torch.cuda.synchronize()
    degrees.reset_launches()
    wire_decode.reset_launches()
    t0 = time.perf_counter()
    (deg,), = EdgeStream.from_wire(bufs, batch, width, cfg, device=dev).aggregate(agg).collect()
    deg = deg.cpu().numpy()
    wall_s = time.perf_counter() - t0
    ef40_once_a_batch("phase 9", nb)
    fold_launches = degrees.LAUNCHES["degree_fold"]
    want = np.bincount(src, minlength=c) + np.bincount(dst, minlength=c)
    if fold_launches != nb or not np.array_equal(deg, want):
        raise RuntimeError(f"DegreeDistributionSummary: {fold_launches} launches, deg equal: {np.array_equal(deg, want)}")
    log(f"  from_wire(...).aggregate(DegreeDistributionSummary()): {wall_s:.3f} s, {nb * batch / wall_s:.6g} edges/s; "
        f"deg equal to np.bincount; degree_fold launched {fold_launches} times")
    s, d = wire.unpack_edges(torch.from_numpy(bufs[-1]).to(dev), batch, width)
    base = torch.from_numpy(want.astype(np.int32)).to(dev)
    # the hub batch: phase 12's hub pane (a star of 2^17 from vertex 0 beside
    # Zipf edges over 2^16 ids)
    hs, hd = (torch.from_numpy(np.ascontiguousarray(x[-SAGE_PANE_EDGES:])).to(dev) for x in sage_stream_arrays())
    rng = np.random.default_rng(6)
    mask = torch.from_numpy(rng.random(batch) < 0.8).to(dev)
    # ids -1, C and C + 5 on some rows: JAX's scatter rule
    so, do = (torch.from_numpy(oor_ids(x.cpu().numpy(), c, k).astype(np.int32)).to(dev) for k, x in enumerate((s, d)))
    errs = {}
    for name, args in (("uniform", (s, d, None)), ("hub", (hs, hd, None)), ("masked", (s, d, mask)),
                       ("ids -1, C, C + 5, masked", (so, do, mask))):
        errs[name] = int((degrees.degree_fold(base.clone(), *args) - degrees.degree_fold_plain(base, *args)).abs().max())
    if any(errs.values()):
        raise RuntimeError(f"degree_fold differs from its twin: {errs}")
    fold_err = max(errs.values())
    acc = base.clone()
    f_ms, f_us = device_ms(lambda: degrees.degree_fold(acc, s, d), UF_REPS, cycles_per_ms)
    hub_ms, _ = device_ms(lambda: degrees.degree_fold(acc, hs, hd), UF_REPS, cycles_per_ms)
    f_events = cuda_ms(lambda: degrees.degree_fold(acc, s, d), UF_REPS)
    f_plain = cuda_ms(lambda: degrees.degree_fold_plain(base, s, d), 5)
    idx = torch.cat([s, d]).long()
    ones = torch.ones(idx.shape, dtype=torch.int32, device=dev)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, idx, ones), UF_REPS)
    f_bound = (8 * batch + 8 * c) / HBM_BYTES_PER_S * 1e3
    # the L2's reduction rate: 2^22 reductions at hashed indices of a 4 MiB
    # vector already in L2, and 2^17 on one address
    lib = _cuda.library("degrees.cu")
    probe = torch.zeros(c, dtype=torch.int32, device=dev)
    rates = {}
    for name, spread, count in (("random", 1, 2 * batch), ("one address", 0, 1 << 17)):
        def red(spread=spread, count=count):
            _cuda.check(lib.degree_l2_probe_launch(probe.data_ptr(), c, spread, count,
                                                   torch.cuda.current_stream(dev).cuda_stream), "degree_l2_probe")
        p_ms, _ = device_ms(red, UF_REPS, cycles_per_ms)
        rates[name] = count / (p_ms * 1e-3)
    red_ms = 2 * batch / rates["random"] * 1e3
    log(f"  degree_fold a batch: device {f_ms:.4f} ms (hub batch {hub_ms:.4f} ms), host enqueue {f_us:.2f} us, "
        f"events {f_events:.4f} ms; index_add_ (int64 index of both endpoints) {lib_ms:.4f} ms; plain twin "
        f"{f_plain:.4f} ms; bound {f_bound:.5f} ms (bytes); equal to the twin on {sorted(errs)}")
    log(f"  the L2's reduction rate: {rates['random']:.4g}/s at random indices of a {4 * c} B vector, "
        f"{rates['one address']:.4g}/s on one address; the batch's {2 * batch} ids as random reductions "
        f"{red_ms:.5f} ms, beside the bytes bound {f_bound:.5f} ms")

    # the fully-dynamic distribution: 2^20 signed events over 2^16 vertices
    rng = np.random.default_rng(1)
    n_ev, nv, ev_batch = DD_EVENTS, DD_VERTICES, DD_BATCH
    es, ed, eg = signed_events(rng, n_ev, nv)
    dcfg = StreamConfig(vertex_capacity=nv)
    degrees.reset_launches()
    t0 = time.perf_counter()
    dd = DegreeDistribution()
    ids, counts = block_columns(dd.run(signed_stream(es, ed, eg, dcfg, ev_batch, dev)))
    dd_s = time.perf_counter() - t0
    scan_launches = degrees.LAUNCHES["degree_dist_scan"]
    t0 = time.perf_counter()
    oracle = np.array(degree_dist_oracle(es, ed, eg), np.int64).reshape(-1, 2)
    oracle_s = time.perf_counter() - t0
    if scan_launches != n_ev // ev_batch:
        raise RuntimeError(f"degree_dist_scan launched {scan_launches} times for {n_ev // ev_batch} batches")
    if len(ids) != len(oracle) or not (np.array_equal(ids, oracle[:, 0]) and np.array_equal(counts, oracle[:, 1])):
        raise RuntimeError("DegreeDistribution differs from the keyed-stage oracle")
    deletes = int((eg < 0).sum())
    log(f"  DegreeDistribution over {n_ev} signed events ({deletes} deletions) on {nv} vertices, batches of "
        f"{ev_batch}: {len(ids)} records in {dd_s:.3f} s, equal to the three-stage dict oracle ({oracle_s:.1f} s); "
        f"degree_dist_scan launched {scan_launches} times")
    # the twin and the one-thread kernel on the first batch, and a run at
    # capacity 2^10 past which hubs' degrees go
    sl = slice(0, ev_batch)
    args = [torch.from_numpy(a[sl]).to(dev) for a in (es, ed, eg)] + [torch.ones(ev_batch, dtype=torch.bool, device=dev)]
    z = torch.zeros(nv, dtype=torch.int32, device=dev)
    got = degrees.degree_dist_scan(z.clone(), z.clone(), *args)
    serial = degrees.degree_dist_scan_serial(z.clone(), z.clone(), *args)
    want_t = degrees.degree_dist_scan_plain(z, z, *args)
    scan_err = max(scan_diff(got, want_t[2:]), scan_diff(got, serial))
    cs, cd, cg = signed_events(rng, DD_CAP_EVENTS, DD_CAP, hubs=4)
    ccfg = StreamConfig(vertex_capacity=DD_CAP)
    cap_dd = DegreeDistribution()
    cap_got = block_columns(cap_dd.run(signed_stream(cs, cd, cg, ccfg, ev_batch, dev)))
    cpu_dd = DegreeDistribution()
    cap_want = block_columns(cpu_dd.run(signed_stream(cs, cd, cg, ccfg, ev_batch, torch.device("cpu"))))
    top = int(cap_dd.final_state.deg.max())
    if top < DD_CAP or not all(np.array_equal(a, b) for a, b in zip(cap_got, cap_want)):
        raise RuntimeError(f"capacity run: max degree {top}, records equal to the twin's: "
                           f"{all(np.array_equal(a, b) for a, b in zip(cap_got, cap_want))}")
    scan_err = max(scan_err, int(not torch.equal(cap_dd.final_state.hist.cpu(), cpu_dd.final_state.hist)))
    if scan_err:
        raise RuntimeError(f"degree_dist_scan differs from its twin or the one-thread kernel ({scan_err})")
    log(f"  first batch equal to the twin and to the one-thread kernel; capacity {DD_CAP} run ({DD_CAP_EVENTS} "
        f"events, max degree {top}) equal to the CPU path's")
    small = scan_turns(dev, cycles_per_ms, es[sl], ed[sl], eg[sl], nv, reps=UF_REPS)

    # the uncut run: the CC bench's stream, signed, in batches of 2^21
    uncut = phase_degree_dist_uncut(dev, data)
    big = scan_turns(dev, cycles_per_ms, data["src"][:CC_BATCH], data["dst"][:CC_BATCH], uncut["sign"][:CC_BATCH],
                     CC_VERTICES, reps=UF_REPS)
    share = big["device_ms"] * uncut["launches"] / (uncut["wall_s"] * 1e3)
    log(f"  the scan's device time x {uncut['launches']} launches = {share * 100:.2f}% of the uncut run's wall")
    return {
        "fold": {"launches": fold_launches, "ms": f_events, "device_ms": f_ms, "host_us": f_us, "plain_ms": f_plain,
                 "bound_ms": f_bound, "library_ms": lib_ms, "err": fold_err, "hub_device_ms": hub_ms,
                 "l2_reductions_per_s": rates, "random_reductions_ms": red_ms,
                 "turns_batches": {"uniform": (s, d), "hub": (hs, hd)}},
        "scan": {"launches": uncut["launches"], "ms": big["ms"], "device_ms": big["device_ms"],
                 "host_us": big["host_us"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
                 "err": max(scan_err, uncut["err"]), "sort_ms": big["sort_ms"], "serial_ms": big["serial_ms"],
                 "batch_events": CC_BATCH, "cut_launches": scan_launches,
                 "small": {k: small[k] for k in ("ms", "device_ms", "sort_ms", "serial_ms", "plain_ms", "bound_ms")},
                 "events_per_s": uncut["events_per_s"], "records_per_s": uncut["records_per_s"]},
    }


def scan_diff(a, b) -> int:
    """Records differing by most, or flags differing, between two
    (records, record mask) pairs; 0 when equal."""
    return max(int((a[0] - b[0]).abs().max()), int((a[1] != b[1]).sum()))


def scan_turns(dev, cycles_per_ms: float, src, dst, sign, capacity: int, reps: int) -> dict:
    """degree_dist_scan on one batch at the main path's shapes: the
    two-stage kernels and the one-thread kernel in turns (two-stage,
    one-thread, one-thread, two-stage; each on its own state), the two
    stable sorts alone on this batch's keys, the twin, and the bound.  A
    call is some 25 launches (each sort several), so ``reps`` stays near
    20: more would fill the device's launch queue behind the held stream
    and block the host."""
    import torch

    from gelly_streaming_tpu_torch.ops import degrees

    n = len(src)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (src, dst, sign)]
    args.append(torch.ones(n, dtype=torch.bool, device=dev))
    fresh = lambda: torch.zeros(capacity, dtype=torch.int32, device=dev)  # noqa: E731
    par_state, ser_state = (fresh(), fresh()), (fresh(), fresh())
    recs, _ = degrees.degree_dist_scan(fresh(), fresh(), *args)
    par = lambda: degrees.degree_dist_scan(*par_state, *args)  # noqa: E731
    ser = lambda: degrees.degree_dist_scan_serial(*ser_state, *args)  # noqa: E731
    turns = {"parallel": [], "serial": []}
    for tag, fn, r in (("parallel", par, reps), ("serial", ser, 1), ("serial", ser, 1), ("parallel", par, reps)):
        turns[tag].append(device_ms(fn, r, cycles_per_ms, warmup=1))
    x = torch.stack([args[0], args[1]], 1).reshape(-1)
    k1 = torch.where(x < 0, x + capacity, x).clamp(0, capacity - 1)
    k2 = recs[..., 0].reshape(-1).clamp(0, capacity - 1)
    sort_ms, _ = device_ms(lambda: (torch.sort(k1, stable=True), torch.sort(k2, stable=True)), reps, cycles_per_ms)
    plain_ms = cuda_ms(lambda: degrees.degree_dist_scan_plain(*par_state, *args), 3, 1)
    events_ms = cuda_ms(par, reps, 1)
    # per event: src, dst (4 B each), sign, mask read; 8 int32 and 4 flags
    # written; then deg read and written once a touched vertex and hist
    # once a touched degree (4 + 4 B each), counted from this batch's keys
    touched_v, touched_d = int(torch.unique(k1).numel()), int(torch.unique(k2).numel())
    bound = (n * (10 + 36) + 8 * touched_v + 8 * touched_d) / HBM_BYTES_PER_S * 1e3
    d_ms = min(t[0] for t in turns["parallel"])
    h_us = min(t[1] for t in turns["parallel"])
    s_ms = min(t[0] for t in turns["serial"])
    log(f"  degree_dist_scan, {n} events over {capacity} vertices, in turns: two-stage device "
        + ", ".join(f"{t[0]:.4f}" for t in turns["parallel"]) + " ms; one-thread kernel "
        + ", ".join(f"{t[0]:.3f}" for t in turns["serial"]) + f" ms ({s_ms / d_ms:.0f}x); the two stable "
        f"torch.sorts alone {sort_ms:.4f} ms (kernels {d_ms - sort_ms:.4f} ms); host enqueue {h_us:.1f} us; "
        f"back-to-back events {events_ms:.4f} ms; twin on the card {plain_ms:.3f} ms; bound {bound:.5f} ms (bytes; "
        f"{touched_v} vertices and {touched_d} degrees touched)")
    try:
        rows = profiler_device_us(par, 5)
        for key, (us, calls) in sorted(rows.items(), key=lambda r: -r[1][0])[:8]:
            log(f"    torch.profiler: {us:.2f} us/call, {calls} calls: {key[:80]}")
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"    torch.profiler failed: {type(e).__name__}: {e}")
    return {"ms": events_ms, "device_ms": d_ms, "host_us": h_us, "sort_ms": sort_ms, "serial_ms": s_ms,
            "plain_ms": plain_ms, "bound_ms": bound}


def phase_degree_dist_uncut(dev, data: dict) -> dict:
    """DegreeDistribution over the CC bench's 104,857,600 edges with signs
    (about 30% deletions, numpy's default_rng(2)) in batches of 2^21 over
    2^20 vertices, end to end; then every batch again through the kernels
    and the twin on the card, records and state compared, the first batch
    also against the one-thread kernel, and the final histogram against
    np.bincount of the final degrees."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.library.degree_distribution import DegreeDistribution
    from gelly_streaming_tpu_torch.ops import degrees

    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    src, dst = data["src"], data["dst"]
    rng = np.random.default_rng(2)
    sign = np.empty(len(src), np.int8)
    for i in range(nb):
        sign[i * batch : (i + 1) * batch] = np.where(rng.random(batch) < 0.3, -1, 1)
    cfg = StreamConfig(vertex_capacity=c)
    # warm the allocator and the sorts outside the counted run
    DegreeDistribution().run(signed_stream(src[:batch], dst[:batch], sign[:batch], cfg, batch, dev)).collect()
    torch.cuda.synchronize()
    degrees.reset_launches()
    t0 = time.perf_counter()
    dd = DegreeDistribution()
    n_rec, id_sum, count_sum = 0, 0, 0
    for blk in dd.run(signed_stream(src, dst, sign, cfg, batch, dev)).blocks():
        ids, counts = blk.columns
        n_rec += len(ids)
        id_sum += int(ids.sum())
        count_sum += int(counts.sum())
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = degrees.LAUNCHES["degree_dist_scan"]
    if launches != nb:
        raise RuntimeError(f"uncut run: degree_dist_scan launched {launches} times for {nb} batches")
    log(f"  DegreeDistribution over the CC bench's {nb * batch} signed events ({int((sign < 0).sum())} "
        f"deletions) on {c} vertices, batches of {batch}: {n_rec} records in {wall_s:.3f} s, "
        f"{nb * batch / wall_s:.6g} events/s, {n_rec / wall_s:.6g} records/s; degree_dist_scan launched "
        f"{launches} times")

    t0 = time.perf_counter()
    zero = lambda: torch.zeros(c, dtype=torch.int32, device=dev)  # noqa: E731
    kern, twin = (zero(), zero()), (zero(), zero())
    err, t_rec, t_id, t_count = 0, 0, 0, 0
    for i in range(nb):
        sl = slice(i * batch, (i + 1) * batch)
        args = [torch.from_numpy(a[sl]).to(dev) for a in (src, dst, sign)]
        args.append(torch.ones(batch, dtype=torch.bool, device=dev))
        if i == 0:
            serial = degrees.degree_dist_scan_serial(zero(), zero(), *args)
        got = degrees.degree_dist_scan(*kern, *args)
        new_deg, new_hist, w_recs, w_mask = degrees.degree_dist_scan_plain(*twin, *args)
        twin = (new_deg, new_hist)
        err = max(err, scan_diff(got, (w_recs, w_mask)), scan_diff(got, serial) if i == 0 else 0)
        kept = w_recs.reshape(-1, 2)[w_mask.reshape(-1)].long()
        t_rec += int(kept.shape[0])
        t_id += int(kept[:, 0].sum())
        t_count += int(kept[:, 1].sum())
    deg, hist = kern[0].cpu().numpy(), kern[1].cpu().numpy()
    state_equal = all(torch.equal(a, b) for a, b in zip(kern, twin)) and \
        torch.equal(dd.final_state.deg, kern[0]) and torch.equal(dd.final_state.hist, kern[1])
    hist_equal = np.array_equal(hist[1:], np.bincount(deg, minlength=c)[1:c])
    sums_equal = (n_rec, id_sum, count_sum) == (t_rec, t_id, t_count)
    if err or not (state_equal and hist_equal and sums_equal):
        raise RuntimeError(f"uncut run: records differ by {err}, state equal {state_equal}, hist equal to "
                           f"np.bincount {hist_equal}, record sums equal {sums_equal}")
    log(f"  every batch's records and flags equal to the twin on the card, the first batch's to the one-thread "
        f"kernel; final deg/hist equal to the twin's and the end-to-end run's; hist[1:] equal to "
        f"np.bincount(deg); max degree {int(deg.max())} ({time.perf_counter() - t0:.1f} s)")
    return {"launches": launches, "wall_s": wall_s, "events_per_s": nb * batch / wall_s,
            "records_per_s": n_rec / wall_s, "err": err, "sign": sign}


def phase_bipartite(dev, cycles_per_ms: float, data: dict) -> dict:
    """Phase 10: BipartitenessCheck over an even -> odd EF40 stream of the
    bench's shape (bipartite: sides differ across every edge, components
    equal to scipy's) and over the uniform stream ((false,{})); a timed
    windowed run against the CPU path."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.io.sources import _batched
    from gelly_streaming_tpu_torch.library.bipartiteness import BipartitenessCheck
    from gelly_streaming_tpu_torch.ops import unionfind as uf
    from gelly_streaming_tpu_torch.ops import wire_decode

    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    width = data["width"]
    bsrc = data["src"] & ~np.int32(1)
    bdst = data["dst"] | np.int32(1)
    t0 = time.perf_counter()
    bbufs = pack_batches(bsrc, bdst, batch, width)
    log(f"  even -> odd stream packed in {time.perf_counter() - t0:.1f} s (host numpy threads, untimed)")
    cfg = StreamConfig(vertex_capacity=c, batch_size=batch)
    agg = BipartitenessCheck()
    EdgeStream.from_wire(bbufs[:1], batch, width, cfg, device=dev).aggregate(agg).collect()
    torch.cuda.synchronize()
    runs = {}
    for name, bufs in (("bipartite", bbufs), ("uniform", data["bufs"])):
        uf.reset_launches()
        wire_decode.reset_launches()
        t0 = time.perf_counter()
        (cand,), = EdgeStream.from_wire(bufs, batch, width, cfg, device=dev).aggregate(agg).collect()
        verdict = cand.is_bipartite()
        wall_s = time.perf_counter() - t0
        ef40_once_a_batch(f"phase 10 ({name})", nb)
        runs[name] = (cand, verdict, wall_s, uf.LAUNCHES["parity_union_kernel"], uf.LAUNCHES["compress_kernel"])
        log(f"  {name}: from_wire(...).aggregate(BipartitenessCheck()) {wall_s:.3f} s first buffer -> verdict, "
            f"{nb * batch / wall_s:.6g} edges/s; is_bipartite {verdict}; launches {dict(uf.LAUNCHES)}")
    cand, verdict, _, launches, compress_launches = runs["bipartite"]
    if not verdict or launches != nb or compress_launches != 1:
        raise RuntimeError(f"the even -> odd stream: is_bipartite {verdict}, {launches} launches")
    p = cand.parent2.cpu().numpy()
    seen = cand.seen.cpu().numpy()
    if not np.all(p[2 * bsrc] != p[2 * bdst]):
        raise RuntimeError("a bipartite edge joins two vertices on one side")
    o_parent, o_seen = cc_oracle(bsrc, bdst, c)
    label = np.minimum(p[0::2], p[1::2]) // 2
    if not (np.array_equal(seen, o_seen) and np.array_equal(label[seen], o_parent[seen])):
        raise RuntimeError("the bipartite stream's components differ from scipy's")
    cand_u, verdict_u, _, launches_u, _ = runs["uniform"]
    if verdict_u or str(cand_u) != "(false,{})" or launches_u != nb:
        raise RuntimeError(f"the uniform stream: {str(cand_u)[:40]}, {launches_u} launches")
    log(f"  bipartite: sides differ across all {nb * batch} edges, {len(np.unique(label[seen]))} components equal "
        f"to scipy's; uniform: (false,{{}})")

    # one batch's parity fold: device time, twin, bound
    s, d = wire.unpack_edges(torch.from_numpy(bbufs[-1]).to(dev), batch, width)
    late = (cand.parent2.clone(), cand.seen.clone())
    init = (uf.init_parity_parent(c, dev), torch.zeros(c, dtype=torch.bool, device=dev))
    so, do = (torch.from_numpy(oor_ids(x.cpu().numpy(), c, k).astype(np.int32)).to(dev) for k, x in enumerate((s, d)))
    err = 0
    for a, b in ((s, d), (so, do)):  # the stream's rows; ids -1, C and C + 5 on some rows
        got = uf.parity_union_edges_with_seen(init[0].clone(), init[1].clone(), a, b)
        want = uf.parity_union_edges_with_seen_plain(*init, a, b)
        err += int((got[0] - want[0]).abs().max()) + int((got[1] != want[1]).sum())
    if err:
        raise RuntimeError(f"the parity union differs from its twin ({err})")
    fold = uf.parity_union_edges_with_seen
    first_ms, first_us = fold_device_ms(fold, *init, s, d, UF_REPS, cycles_per_ms)
    late_ms, late_us = fold_device_ms(fold, *late, s, d, UF_REPS, cycles_per_ms, flat=True)
    rounds = {}
    for name, (p0, sn0), flat in (("first", init, False), ("late", late, True)):
        fold(uf.mark_flat(p0.clone()) if flat else p0.clone(), sn0.clone(), s, d)
        rounds[name] = uf.last_rounds()
    log(f"  the parity call's rounds: first batch {rounds['first']}, late batch {rounds['late']}; "
        f"equal to the twin with ids -1, C, C + 5 on every 997th row")
    copies = iter([(uf.mark_flat(late[0].clone()), late[1].clone()) for _ in range(UF_REPS + 2)])
    ev_ms = cuda_ms(lambda: uf.parity_union_edges_with_seen(*next(copies), s, d), UF_REPS)
    plain_first = cuda_ms(lambda: uf.parity_union_edges_with_seen_plain(*init, s, d), 1, 0)
    plain_late = cuda_ms(lambda: uf.parity_union_edges_with_seen_plain(*late, s, d), 1, 0)
    # each kernel's held-stream time: the call with no edges is compress
    # over the 2C doubled nodes alone, and the parity union is the rest
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    comp_ms, comp_us = fold_device_ms(fold, *late, none, none, UF_REPS, cycles_per_ms)
    union_ms, union_us = late_ms, late_us
    per_kernel, split_by = {}, "torch.profiler"
    try:
        per_kernel = union_kernel_profile(*late, s, d, 10, fold=fold)
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")
    if len(per_kernel) < 2:
        per_kernel = {"union_kernel": union_ms * 1e3, "compress_kernel": comp_ms * 1e3}
        split_by = "held-stream times (the profiler showed no kernel rows)"
    # the parity union alone: src/dst read (8 B a row), parent2 read (4 B a
    # doubled node, 2C of them), seen written (1 B a vertex); compress of the
    # doubled space reads and writes parent2 (16 B a vertex)
    bound = (8 * batch + 9 * c) / HBM_BYTES_PER_S * 1e3
    compress_bound = 16 * c / HBM_BYTES_PER_S * 1e3
    log(f"  parity fold a batch (one C call), device only: first (compress + parity union) {first_ms:.4f} ms, "
        f"late (parity union, the state known flat) {late_ms:.4f} ms; host enqueue {first_us:.1f} / "
        f"{late_us:.1f} us; events (late) {ev_ms:.4f} ms; plain twin {plain_first:.2f} / {plain_late:.2f} ms")
    log(f"  per kernel on the late batch, by {split_by}: parity union_kernel "
        f"{per_kernel['union_kernel']:.2f} us, compress_kernel (2C nodes) {per_kernel['compress_kernel']:.2f} us "
        f"a launch; held stream: compress alone (a call with no edges) {comp_ms * 1e3:.2f} us; bounds "
        f"{bound * 1e3:.3f} / {compress_bound * 1e3:.3f} us (bytes)")

    # the windowed path at a smaller depth: panes folded in two partitions,
    # combined and merged by merge_parents on the doubled space
    rng = np.random.default_rng(3)
    wn, wc = BP_WINDOW_EDGES, BP_WINDOW_VERTICES
    ws = (rng.integers(0, wc // 2, wn) * 2).astype(np.int32)
    wd = (rng.integers(0, wc // 2, wn) * 2 + 1).astype(np.int32)
    odd = rng.choice(np.arange(wn // 2, wn), 3, replace=False)  # odd cycles after half the stream
    ws[odd] = wd[odd] - 2 * rng.integers(1, 4, 3).astype(np.int32)
    tim = np.sort(rng.integers(0, 4 * 1000, wn))
    wcfg = StreamConfig(vertex_capacity=wc, num_shards=2)

    def windowed(device):
        stream = EdgeStream.from_batches(_batched(ws, wd, None, tim, None, 1 << 14, device), wcfg, device=device)
        return [(r[0].parent2.cpu(), r[0].seen.cpu(), r[0].is_bipartite())
                for r in stream.aggregate(BipartitenessCheck(window_ms=1000)).collect()]

    t0 = time.perf_counter()
    on_card = windowed(dev)
    card_s = time.perf_counter() - t0
    on_cpu = windowed(torch.device("cpu"))
    if len(on_card) != 4 or any(not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2])
                                for a, b in zip(on_card, on_cpu)):
        raise RuntimeError("the windowed bipartiteness check differs from the CPU path")
    log(f"  windowed: {wn} timed edges over {wc} vertices, 4 windows of 1000 ms, 2 partitions: every emission "
        f"equal to the CPU path ({card_s:.2f} s on the card); verdicts {[r[2] for r in on_card]}")
    return {"launches": launches, "compress_launches": compress_launches, "ms": per_kernel["union_kernel"] / 1e3,
            "device_ms": union_ms, "host_us": union_us, "plain_ms": plain_late, "bound_ms": bound, "err": err,
            "first_ms": first_ms, "late_ms": late_ms, "rounds": rounds,
            "turns": {"init": init, "late": late, "first_batch": (s, d), "late_batch": (s, d)}}


# ---------------------------------------------------------------------------
# phase 12: slice() and windowed GraphSAGE on the card


def sage_stream_arrays(seed: int = 3):
    """(src, dst) int32 of the GraphSAGE run: SAGE_PANES panes of uniform
    edges over SAGE_VERTICES, then the hub pane, a star of SAGE_HUB edges
    from vertex 0 beside Zipf edges over 2^16 other ids."""
    rng = np.random.default_rng(seed)
    c, e = SAGE_VERTICES, SAGE_PANE_EDGES
    src = rng.integers(0, c, SAGE_PANES * e, dtype=np.int32)
    dst = rng.integers(0, c, SAGE_PANES * e, dtype=np.int32)
    ids = rng.permutation(np.arange(1, c))[: 1 << 16]
    zs, zd = zipf_edges(rng, len(ids), e - SAGE_HUB)
    hub_src = np.concatenate([np.zeros(SAGE_HUB, np.int64), ids[zs]])
    hub_dst = np.concatenate([rng.integers(1, c, SAGE_HUB), ids[zd]])
    perm = rng.permutation(e)
    return (np.concatenate([src, hub_src[perm].astype(np.int32)]),
            np.concatenate([dst, hub_dst[perm].astype(np.int32)]))


class twins_in_place:
    """Within the block, the port's build_buckets and sage_layer are their
    plain twins (the library and the snapshot look them up at each call)."""

    def __enter__(self):
        from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
        from gelly_streaming_tpu_torch.ops import sage

        def layer_plain(table, keys, nbrs, valid, w, bias, out=None, row0=0):
            got = sage.sage_layer_plain(table, keys, nbrs, valid, w, bias)
            return got if out is None else out[row0:row0 + keys.shape[0]].copy_(got)

        self.saved = (nbh.build_buckets, sage.sage_layer)
        nbh.build_buckets, sage.sage_layer = nbh.build_buckets_plain, layer_plain

    def __exit__(self, *exc):
        from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
        from gelly_streaming_tpu_torch.ops import sage

        nbh.build_buckets, sage.sage_layer = self.saved


def directed_all(s, d):
    """slice(ALL)'s directed rows of one pane."""
    return np.concatenate([s, d]), np.concatenate([d, s])


def buckets_err(got, want) -> int:
    """0 when two bucket lists are equal exactly (shapes, keys, nbrs, valid,
    num_keys), else 1."""
    import torch

    if len(got) != len(want):
        return 1
    for g, w in zip(got, want):
        if g.num_keys != w.num_keys:
            return 1
        for a, b in ((g.keys, w.keys), (g.nbrs, w.nbrs), (g.valid, w.valid)):
            if a.shape != b.shape or not torch.equal(a, b):
                return 1
    return 0


def mean_view(table):
    """(table, w, bias) under which sage_layer writes bf16(mean): |table| + 1
    (ReLU keeps every mean), W = [0; I] and no bias."""
    import torch

    f = table.shape[1]
    eye = torch.cat([torch.zeros(f, f), torch.eye(f)]).to(table.device, torch.bfloat16)
    return (table.float().abs() + 1).to(torch.bfloat16), eye, torch.zeros(f, dtype=torch.bfloat16, device=table.device)


def layer_err(table, buckets, w, bias, mean_args) -> tuple:
    """(max |kernel - twin|, the same over the buckets whose rows of more
    than 32 slots go through the partial-sum kernel, the largest |ref|
    there, the mean's max |kernel - twin| relative to |twin|) of sage_layer
    over a pane's buckets, each output within SAGE_TWIN_RTOL * |twin| +
    SAGE_TWIN_ATOL; under ``mean_args`` (mean_view) each mean within
    SAGE_MEAN_RTOL * |twin| + SAGE_MEAN_ATOL."""
    import torch

    from gelly_streaming_tpu_torch.ops import sage

    worst = worst_chunked = mag_chunked = mean_rel = 0.0
    for b in buckets:
        if not b.num_keys:
            continue
        d = b.nbrs.shape[1]
        got = sage.sage_layer(table, b.keys, b.nbrs, b.valid, w, bias).float()
        ref = sage.sage_layer_plain(table, b.keys, b.nbrs, b.valid, w, bias).float()
        diff = (got - ref).abs()
        if bool((diff > SAGE_TWIN_RTOL * ref.abs() + SAGE_TWIN_ATOL).any()):
            raise RuntimeError(f"sage_layer differs from its twin past {SAGE_TWIN_RTOL} * |ref| + "
                               f"{SAGE_TWIN_ATOL} (D={d}, max |err| {float(diff.max()):.6g})")
        worst = max(worst, float(diff.max()))
        if d > sage._DIRECT:
            worst_chunked = max(worst_chunked, float(diff.max()))
            mag_chunked = max(mag_chunked, float(ref.abs().max()))
        got = sage.sage_layer(mean_args[0], b.keys, b.nbrs, b.valid, *mean_args[1:]).float()
        ref = sage.sage_layer_plain(mean_args[0], b.keys, b.nbrs, b.valid, *mean_args[1:]).float()
        diff = (got - ref).abs()
        if bool((diff > SAGE_MEAN_RTOL * ref.abs() + SAGE_MEAN_ATOL).any()):
            raise RuntimeError(f"sage_layer's mean differs from its twin's past {SAGE_MEAN_RTOL} * |ref| + "
                               f"{SAGE_MEAN_ATOL} (D={d}, max |err| {float(diff.max()):.6g})")
        mean_rel = max(mean_rel, float((diff / ref.abs().clamp(min=1)).max()))
    return worst, worst_chunked, mag_chunked, mean_rel


def sage_oracle_err(feats64, params, s, d, keys, emb) -> tuple:
    """A float64 oracle of one window, numpy and scipy: the grouping (every
    vertex of the pane keyed once) and the layer relu(x W_self + mean W_nbr +
    b) on the f32 features (``feats64``, as float64), the neighbor sums as a
    sparse product.  Returns (max |emb - ref|, max of |emb - ref| - SAGE_TOL *
    (1 + |ref|), keys checked)."""
    import scipy.sparse as sp

    s_dir, d_dir = directed_all(s, d)
    adj = sp.csr_matrix((np.ones(len(s_dir)), (s_dir, d_dir)), shape=(SAGE_VERTICES, SAGE_VERTICES))
    count = np.bincount(s_dir, minlength=SAGE_VERTICES)
    uniq = np.flatnonzero(count)
    order = np.argsort(keys)
    if len(keys) != len(uniq) or not np.array_equal(keys[order], uniq):
        raise RuntimeError("the window's keys are not the pane's vertices, each once")
    ws, wn, b = (p.double().cpu().numpy() for p in params)
    mean = (adj[uniq] @ feats64) / count[uniq, None]
    ref = np.maximum(feats64[uniq] @ ws + mean @ wn + b, 0.0)
    diff = np.abs(emb[order] - ref)
    return float(diff.max()), float((diff - SAGE_TOL * (1 + np.abs(ref))).max()), len(uniq)


def build_launcher(ts, td, tm):
    """(launch, sort): callables making build_buckets' C calls over one pane
    into pre-allocated outputs, without the host's read of the counts:
    the sort, count and scatter calls, and the sort alone."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh

    lib = _cuda.library("neighborhoods.cu")
    e = ts.shape[0]
    nb = len(nbh.bucket_shapes(e))
    dev = ts.device
    scratch = torch.empty(lib.nb_scratch_bytes(e, 0), dtype=torch.uint8, device=dev)
    totals = torch.empty(nb, dtype=torch.int32, device=dev)
    counts = [b.num_keys for b in nbh.build_buckets(ts, td, None, tm)]
    slots = sum(n << b for b, n in enumerate(counts))
    keys_out = torch.empty(sum(counts), dtype=torch.int32, device=dev)
    nbrs_out = torch.empty(slots, dtype=torch.int32, device=dev)
    valid_out = torch.empty(slots, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sp = (scratch.data_ptr(), scratch.numel())

    def sort():
        _cuda.check(lib.nb_sort_launch(ts.data_ptr(), td.data_ptr(), tm.data_ptr(), e, 0, *sp, stream),
                    "nb_sort_launch")

    def launch():
        sort()
        _cuda.check(lib.nb_count_launch(e, nb, 0, *sp, totals.data_ptr(), stream), "nb_count_launch")
        _cuda.check(lib.nb_scatter_launch(e, nb, 0, *sp, keys_out.data_ptr(), nbrs_out.data_ptr(),
                                          valid_out.data_ptr(), stream), "nb_scatter_launch")

    return launch, sort


def parent_build_launcher(lib, ts, td, tm):
    """The parent's build over one pane into pre-allocated outputs: the
    stable torch.sort of the grouping keys, then its count and scatter
    calls (its C interface)."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh

    e = ts.shape[0]
    nb = len(nbh.bucket_shapes(e))
    dev = ts.device
    tiles = (e + 1023) // 1024
    tile_base = torch.empty(nb * tiles, dtype=torch.int32, device=dev)
    info = torch.empty(2 * e, dtype=torch.int32, device=dev)
    offsets = torch.empty(2 * nb, dtype=torch.int64, device=dev)
    totals = torch.empty(nb, dtype=torch.int32, device=dev)
    counts = [b.num_keys for b in nbh.build_buckets(ts, td, None, tm)]
    slots = sum(n << b for b, n in enumerate(counts))
    keys_out = torch.empty(sum(counts), dtype=torch.int32, device=dev)
    nbrs_out = torch.empty(slots, dtype=torch.int32, device=dev)
    valid_out = torch.empty(slots, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gk = (ts << 1) | (~tm).to(torch.int32)

    def launch():
        keys, order = torch.sort(gk, stable=True)
        _cuda.check(lib.nb_count_launch(keys.data_ptr(), e, nb, tile_base.data_ptr(), info.data_ptr(),
                                        offsets.data_ptr(), totals.data_ptr(), stream), "parent nb_count_launch")
        _cuda.check(lib.nb_scatter_launch(keys.data_ptr(), order.data_ptr(), e, nb, tile_base.data_ptr(),
                                          info.data_ptr(), offsets.data_ptr(), ts.data_ptr(), td.data_ptr(),
                                          keys_out.data_ptr(), nbrs_out.data_ptr(), valid_out.data_ptr(), stream),
                    "parent nb_scatter_launch")
        return keys_out, nbrs_out, valid_out

    return launch


def parent_layer(lib, table, hoods, w, bias):
    """The parent's layer over a pane's buckets: its gather-mean kernel (and
    finish kernel for rows past 256 slots), then torch.addmm with the
    stacked weights and ReLU, a bucket at a time."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda

    c, f = table.shape
    dev = table.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    plans = []
    for b in hoods:
        k, d = b.nbrs.shape
        nch = max(1, -(-d // 256))
        part = torch.empty((k * nch, f), dtype=torch.float32, device=dev) if nch > 1 else None
        cnt = torch.empty((k * nch,), dtype=torch.int32, device=dev) if nch > 1 else None
        plans.append((b, k, d, nch, part, cnt))

    def run():
        outs = []
        for b, k, d, nch, part, cnt in plans:
            xm = torch.empty((k, 2 * f), dtype=torch.bfloat16, device=dev)
            _cuda.check(lib.sage_gather_mean_launch(
                table.data_ptr(), c, f, b.keys.data_ptr(), b.nbrs.data_ptr(), b.valid.data_ptr(), k, d, 256, nch, 1,
                xm.data_ptr(), None if part is None else part.data_ptr(), None if cnt is None else cnt.data_ptr(),
                stream), "parent sage_gather_mean_launch")
            outs.append(torch.relu_(torch.addmm(bias, xm, w)))
        return outs

    return run


def in_turns(label: str, old_fn, new_fn, reps: int, cycles_per_ms: float) -> dict:
    """Device-only ms of the parent's and the current build in turns
    (parent, current, current, parent) on the held stream."""
    got = [(tag, device_ms(fn, reps, cycles_per_ms)[0])
           for tag, fn in (("parent", old_fn), ("current", new_fn), ("current", new_fn), ("parent", old_fn))]
    old, new = (got[0][1] + got[3][1]) / 2, (got[1][1] + got[2][1]) / 2
    log(f"  {label}: " + "; ".join(f"{tag} {ms:.4f} ms" for tag, ms in got)
        + f"; mean parent {old:.4f} ms, current {new:.4f} ms, {old / new:.2f}x")
    return {"parent_ms": old, "current_ms": new, "turns": [ms for _, ms in got]}


def sage_pane_times(dev, cycles_per_ms: float, label: str, s, d, table, w, bias, parents: dict, reps: int) -> dict:
    """build_buckets and the layer at one pane's shapes, device only on the
    held stream: the build's sort, count and scatter calls, the radix sort
    alone, torch.sort(stable=True) of the same keys (the build's library
    yardstick), the whole call; sage_layer over the pane's buckets into one
    buffer, its bound, embedding_bag + addmm (the layer's yardstick); the
    parent's builds in turns where given."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
    from gelly_streaming_tpu_torch.ops import sage

    f_in, f_out = table.shape[1], w.shape[1]
    ts, td = to_dev(directed_all(s, d), dev)
    ones = torch.ones(ts.shape[0], dtype=torch.bool, device=dev)
    n = ts.shape[0]
    launch, sort = build_launcher(ts, td, ones)
    b_ms, b_us = device_ms(launch, reps, cycles_per_ms)
    b_events = cuda_ms(launch, reps)
    rs_ms, _ = device_ms(sort, reps, cycles_per_ms)
    keys32 = (ts << 1) | (~ones).to(torch.int32)
    tsort_ms, _ = device_ms(lambda: torch.sort(keys32, stable=True), reps, cycles_per_ms)
    call_ms = cuda_ms(lambda: nbh.build_buckets(ts, td, None, ones), reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        nbh.build_buckets(ts, td, None, ones)
    call_host_ms = (time.perf_counter() - t0) / reps * 1e3
    build_plain_ms = cuda_ms(lambda: nbh.build_buckets_plain(ts, td, None, ones), 2, 1)
    buckets = nbh.build_buckets(ts, td, None, ones)
    counts = [b.num_keys for b in buckets]
    slots = sum(b.nbrs.numel() for b in buckets)
    build_bound = (9 * n + 4 * sum(counts) + 5 * slots) / HBM_BYTES_PER_S * 1e3
    lohi = (int(ts.min()), int(ts.max()))
    log(f"  {label} pane, build_buckets (radix sort, count, scatter), device only: {b_ms:.4f} ms for {n} rows, "
        f"{sum(counts)} keys, {slots} slots ({len(nbh.radix_plan(*lohi))} digit passes for sources in {lohi}); "
        f"{b_ms / build_bound:.2f}x the bound {build_bound:.5f} ms (bytes); host enqueue {b_us:.2f} us; "
        f"back-to-back events {b_events:.4f} ms; the radix sort alone {rs_ms:.4f} ms; torch.sort(stable=True) "
        f"of the int32 grouping keys alone {tsort_ms:.4f} ms; the whole call (with the counts' copy to the host "
        f"and the allocations) {call_ms:.4f} ms by events, {call_host_ms:.4f} ms on the host's clock, of which "
        f"not device work {call_ms - b_ms:.4f} ms; plain twin {build_plain_ms:.3f} ms")

    hoods = [b for b in buckets if b.num_keys]
    rows = sum(b.num_keys for b in hoods)
    emb = torch.empty((rows, f_out), dtype=torch.bfloat16, device=dev)

    def layer():
        row0 = 0
        for b in hoods:
            sage.sage_layer(table, b.keys, b.nbrs, b.valid, w, bias, out=emb, row0=row0)
            row0 += b.num_keys
        return emb

    l_ms, l_us = device_ms(layer, reps, cycles_per_ms)
    l_events = cuda_ms(layer, reps)
    l_plain_ms = cuda_ms(lambda: [sage.sage_layer_plain(table, b.keys, b.nbrs, b.valid, w, bias) for b in hoods], 2, 1)
    gslots = sum(b.nbrs.numel() for b in hoods)
    valid_n = sum(int(b.valid.sum()) for b in hoods)
    # each input once: ids and flags, each distinct table row that a key or a
    # valid neighbor names (under slice(ALL) the neighbors are keys too), W
    # and the bias; the output once
    distinct = int(torch.unique(torch.cat([b.keys for b in hoods] + [b.nbrs[b.valid] for b in hoods])).numel())
    l_bytes = 4 * rows + 5 * gslots + 2 * f_in * distinct + 2 * (2 * f_in * f_out + f_out) + 2 * f_out * rows
    l_ops = 2 * rows * 2 * f_in * f_out
    l_bytes_ms = l_bytes / HBM_BYTES_PER_S * 1e3
    l_ops_ms = l_ops / BF16_FLOPS_PER_S * 1e3
    l_bound = max(l_bytes_ms, l_ops_ms)
    # the yardstick: embedding_bag(mode="mean") over the valid neighbors in
    # CSR form, then addmm over [x_self | mean] (timed only; on no path)
    flat = torch.cat([b.nbrs[b.valid] for b in hoods]).long()
    offs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(torch.cat([b.valid.sum(1) for b in hoods]), 0)[:-1]])
    keys_all = torch.cat([b.keys for b in hoods]).long()
    bag = torch.nn.functional.embedding_bag(flat, table, offs, mode="mean")
    xm = torch.cat([table[keys_all], bag.to(torch.bfloat16)], 1)
    lib_emb = torch.relu(torch.addmm(bias, xm, w))
    lib_err = float((lib_emb.float() - layer().float()).abs().max())
    bag_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(flat, table, offs, mode="mean"), reps)
    mm_ms = cuda_ms(lambda: torch.addmm(bias, xm, w), reps)
    log(f"  {label} pane, sage_layer over its {len(hoods)} buckets ({rows} rows, {valid_n} neighbor rows), device "
        f"only: {l_ms:.4f} ms, host enqueue {l_us:.1f} us ({l_us / len(hoods):.2f} us a launch); back-to-back events "
        f"{l_events:.4f} ms; bound {l_bound:.5f} ms ({'bytes' if l_bytes_ms >= l_ops_ms else 'operations'}: "
        f"{l_bytes} B, {distinct} distinct table rows, {l_bytes_ms:.5f} ms; {l_ops} bf16 operations, "
        f"{l_ops_ms:.5f} ms), {l_ms / l_bound:.3f}x it; plain twin {l_plain_ms:.3f} ms; yardstick "
        f"embedding_bag(mode='mean') {bag_ms:.4f} ms + addmm {mm_ms:.4f} ms = {bag_ms + mm_ms:.4f} ms (max |diff| "
        f"of its relu to the kernel's {lib_err:.4g})")
    out = {
        "build": {"ms": b_events, "device_ms": b_ms, "host_us": b_us, "plain_ms": build_plain_ms,
                  "bound_ms": build_bound, "sort_ms": rs_ms, "torch_sort_ms": tsort_ms, "call_ms": call_ms,
                  "call_host_ms": call_host_ms, "passes": len(nbh.radix_plan(*lohi))},
        "layer": {"ms": l_events, "device_ms": l_ms, "host_us": l_us, "plain_ms": l_plain_ms, "bound_ms": l_bound,
                  "bound_by": "bytes" if l_bytes_ms >= l_ops_ms else "operations", "bytes_ms": l_bytes_ms,
                  "ops_ms": l_ops_ms, "library_ms": bag_ms + mm_ms, "embedding_bag_ms": bag_ms, "addmm_ms": mm_ms,
                  "launches": len(hoods)},
    }
    if "sage" in parents:
        old = parent_layer(parents["sage"], table, hoods, w, bias)
        ref = torch.cat(old()).float()
        diff = (ref - layer().float()).abs()
        if bool((diff > SAGE_TWIN_RTOL * ref.abs() + SAGE_TWIN_ATOL).any()):
            raise RuntimeError(f"the parent's layer and sage_layer disagree on the {label} pane")
        out["layer"]["turns"] = in_turns(f"{label} pane, the layer (parent: gathers, addmm, relu)", old, layer,
                                         reps, cycles_per_ms)
    if "neighborhoods" in parents:
        old = parent_build_launcher(parents["neighborhoods"], ts, td, ones)
        flat_new = [torch.cat([getattr(b, a).reshape(-1) for b in buckets]) for a in ("keys", "nbrs", "valid")]
        if not all(torch.equal(x, y) for x, y in zip(old(), flat_new)):
            raise RuntimeError(f"the parent's build and build_buckets disagree on the {label} pane")
        out["build"]["turns"] = in_turns(f"{label} pane, the build (parent: torch.sort, count, scatter)", old,
                                         launch, reps, cycles_per_ms)
    return out


def sage_width_times(dev, cycles_per_ms: float, s, d) -> dict:
    """Device-only ms of sage_layer over one pane's buckets at each of
    SAGE_WIDTHS (random bf16 table, W and bias made on the card)."""
    import torch

    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
    from gelly_streaming_tpu_torch.ops import sage

    ts, td = to_dev(directed_all(s, d), dev)
    hoods = [b for b in nbh.build_buckets(ts, td, None, torch.ones_like(ts, dtype=torch.bool)) if b.num_keys]
    rows = sum(b.num_keys for b in hoods)
    out = {}
    for f_in, f_out in SAGE_WIDTHS:
        g = torch.Generator(device=dev).manual_seed(f_in)
        table = torch.randn((SAGE_VERTICES, f_in), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((2 * f_in, f_out), generator=g, device=dev) / f_in ** 0.5).to(torch.bfloat16)
        bias = torch.zeros(f_out, dtype=torch.bfloat16, device=dev)
        emb = torch.empty((rows, f_out), dtype=torch.bfloat16, device=dev)

        def layer():
            row0 = 0
            for b in hoods:
                sage.sage_layer(table, b.keys, b.nbrs, b.valid, w, bias, out=emb, row0=row0)
                row0 += b.num_keys

        ms, _ = device_ms(layer, 3, cycles_per_ms)
        out[f"{f_in}->{f_out}"] = ms
        del table
    log(f"  sage_layer alone over the uniform pane's {len(hoods)} buckets at other widths, device only: "
        + ", ".join(f"F {k} {v:.4f} ms" for k, v in out.items()))
    return out


def phase_sage(dev, cycles_per_ms: float, parents: dict) -> dict:
    """Phase 12: slice(ALL) and GraphSAGEWindows.run at the repo's width over
    SAGE_PANES count-cut panes of uniform edges and one hub pane; every pane's
    build_buckets equal to its twin on the card and its sort's order equal
    to torch.sort(stable=True)'s, sage_layer within the tolerance of its
    twin, one window against a float64 numpy oracle, a 2-layer stack
    against the twins, a fold_neighbors degree count against np.bincount,
    launches counted on the main path, and the times, with the parent's
    builds (``parents``: "sage", "neighborhoods" -> loaded library) in
    turns."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.core.types import EdgeDirection
    from gelly_streaming_tpu_torch.library import graphsage as gs
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
    from gelly_streaming_tpu_torch.ops import sage

    c, f, e = SAGE_VERTICES, SAGE_FEATURES, SAGE_PANE_EDGES
    n_panes = SAGE_PANES + 1
    t0 = time.perf_counter()
    src, dst = sage_stream_arrays()
    feats = np.random.default_rng(4).standard_normal((c, f), dtype=np.float32)
    params = gs.init_params(f, f, generator=torch.Generator().manual_seed(0), device=dev)
    cfg = StreamConfig(vertex_capacity=c, batch_size=e, ingest_window_edges=e)
    model = gs.GraphSAGEWindows(params, feats, device=dev)
    log(f"  inputs (untimed, {time.perf_counter() - t0:.2f} s): {n_panes} panes of {e} edges over {c} vertices "
        f"({SAGE_PANES} uniform, one hub: a star of {SAGE_HUB} beside Zipf edges), features [{c}, {f}] f32, "
        f"F_in = F_out = {f}")

    def snapshot(s=src, d=dst):
        return EdgeStream.from_arrays(s, d, cfg, device=dev).slice(WINDOW_MS, EdgeDirection.ALL)

    for _ in model.run(snapshot(src[:e], dst[:e])):  # warm: library loads, allocator, pinned pool
        pass
    torch.cuda.synchronize()

    # the main path, counted: GraphSAGEWindows.run over slice(ALL)
    kept, sizes, window_s = {}, [], []
    check_s = 0.0
    nbh.reset_launches()
    sage.reset_launches()
    t0 = t_prev = time.perf_counter()
    for w, (keys, emb) in enumerate(model.run(snapshot())):
        t_check = time.perf_counter()
        window_s.append(t_check - t_prev)
        if emb.shape != (len(keys), f) or not np.isfinite(emb).all():
            raise RuntimeError(f"window {w}: embeddings of shape {emb.shape} or not finite")
        sizes.append(len(keys))
        if w in (0, SAGE_PANES):
            kept[w] = (keys.copy(), emb.copy())
        del keys, emb
        t_prev = time.perf_counter()
        check_s += t_prev - t_check
    wall = time.perf_counter() - t0 - check_s
    launches = {"build_buckets": nbh.LAUNCHES["build_buckets"], "sage_layer": sage.LAUNCHES["sage_layer"]}
    if len(sizes) != n_panes or launches["build_buckets"] != n_panes or launches["sage_layer"] <= 0:
        raise RuntimeError(f"{len(sizes)} windows, launches {launches}")
    for w in range(n_panes):
        s, d = src[w * e:(w + 1) * e], dst[w * e:(w + 1) * e]
        if sizes[w] != np.count_nonzero(np.bincount(np.concatenate([s, d]), minlength=c)):
            raise RuntimeError(f"window {w}: {sizes[w]} keys, not the pane's vertex count")
    n_emb = sum(sizes)
    # the same run again, for the spread
    t0 = t_prev = time.perf_counter()
    again = []
    for keys, emb in model.run(snapshot()):
        t_now = time.perf_counter()
        again.append(t_now - t_prev)
        del keys, emb
        t_prev = time.perf_counter()
    log(f"  a second run: {sum(again):.3f} s, {n_panes / sum(again):.6g} windows/s; per window "
        f"{[round(x * 1e3, 1) for x in again]} ms")
    log(f"  GraphSAGEWindows.run over slice(ALL): {n_panes} windows, {n_emb} embeddings in {wall:.3f} s "
        f"(the smoke's checks, {check_s:.3f} s more, excluded): {n_panes / wall:.6g} windows/s, "
        f"{n_panes * e / wall:.6g} edges/s, {n_emb / wall:.6g} embeddings/s; per window "
        f"{[round(x * 1e3, 1) for x in window_s]} ms; launches {launches}")

    # every pane: build_buckets against its twin on the card and its sort
    # against torch.sort(stable=True); sage_layer on the first, the hub and
    # the out-of-range pane; ids -1, C and C + 5 on the first pane
    build_err, sort_err, layer_worst, n_buckets, passes = 0, 0, (0.0, 0.0, 0.0, 0.0), [], []
    table, w_stacked, bias = model._table, model._weights[0], params.bias
    mean_args = mean_view(table)
    ones = torch.ones(2 * e, dtype=torch.bool, device=dev)
    for w in range(n_panes + 1):
        s, d = src[(w % n_panes) * e:(w % n_panes + 1) * e], dst[(w % n_panes) * e:(w % n_panes + 1) * e]
        if w == n_panes:
            s, d = oor_ids(s, c).astype(np.int32), oor_ids(d, c, 1).astype(np.int32)
        ts, td = to_dev(directed_all(s, d), dev)
        got = nbh.build_buckets(ts, td, None, ones)
        build_err = max(build_err, buckets_err(got, nbh.build_buckets_plain(ts, td, None, ones)))
        rs, rd, ri, n_pass = nbh.sort_valid_rows(ts, td, ones)
        sort_err = max(sort_err, int(not all(torch.equal(a, b) for a, b in
                                             zip((rs, rd, ri), nbh.sort_valid_rows_plain(ts, td, ones)))))
        passes.append(n_pass)
        n_buckets.append(sum(1 for b in got if b.num_keys))
        if w in (0, SAGE_PANES, n_panes):
            layer_worst = tuple(map(max, layer_worst, layer_err(table, got, w_stacked, bias, mean_args)))
    if build_err or sort_err:
        raise RuntimeError(f"build_buckets differs from its twin ({build_err}) or its sort from torch.sort's "
                           f"order ({sort_err}) on the card")
    if launches["sage_layer"] != sum(n_buckets[:n_panes]):
        raise RuntimeError(f"sage_layer launched {launches['sage_layer']} times for "
                           f"{sum(n_buckets[:n_panes])} non-empty buckets")
    log(f"  build_buckets equal to its twin on the card on all {n_panes} panes and with ids -1, C and C + 5 "
        f"(keys, nbrs, valid, num_keys); its radix sort's order equal to torch.sort(stable=True)'s on every "
        f"pane (passes a pane {passes}); sage_layer within {SAGE_TWIN_RTOL} * |ref| + {SAGE_TWIN_ATOL} of its "
        f"twin on the first, the hub and the out-of-range pane (max |err| {layer_worst[0]:.6g}; in the buckets "
        f"of rows past {sage._DIRECT} slots, which the partial-sum kernel starts, {layer_worst[1]:.6g} where the "
        f"largest |ref| is {layer_worst[2]:.6g}); its mean alone (W = [0; I], no bias, |table| + 1) within "
        f"{SAGE_MEAN_RTOL} * |ref| + {SAGE_MEAN_ATOL} of the twin's on the same buckets (max |err| / |ref| "
        f"{layer_worst[3]:.6g}, the error over max(|ref|, 1)); non-empty buckets a pane {n_buckets}")
    del mean_args

    # one window against numpy, float64; the hub window's hub row too
    t_or = time.perf_counter()
    feats64 = feats.astype(np.float64)
    oracle = sage_oracle_err(feats64, params, src[:e], dst[:e], *kept[0])
    hub = sage_oracle_err(feats64, params, src[SAGE_PANES * e:], dst[SAGE_PANES * e:], *kept[SAGE_PANES])
    del feats64
    if oracle[1] > 0 or hub[1] > 0:
        raise RuntimeError(f"embeddings differ from the float64 oracle past {SAGE_TOL} * (1 + |ref|): "
                           f"{oracle}, {hub}")
    log(f"  windows 0 and {SAGE_PANES} (hub) against a float64 oracle (numpy, scipy) of the grouping and the layer: "
        f"{oracle[2]} and {hub[2]} keys, max |emb - ref| {oracle[0]:.6g} and {hub[0]:.6g}, all within "
        f"{SAGE_TOL} * (1 + |ref|) (the largest |emb - ref| - {SAGE_TOL} * (1 + |ref|): {oracle[1]:.6g} and "
        f"{hub[1]:.6g}; {time.perf_counter() - t_or:.1f} s)")

    # two stacked layers over two panes, against the twins
    two = gs.GraphSAGEWindows(
        [params, gs.init_params(f, f, generator=torch.Generator().manual_seed(1), device=dev)], model._table,
        device=dev)
    got = list(two.run(snapshot(src[:2 * e], dst[:2 * e])))
    with twins_in_place():
        want = list(two.run(snapshot(src[:2 * e], dst[:2 * e])))
    stack_err = 0.0
    for (gk, ge), (wk, we) in zip(got, want):
        if not np.array_equal(gk, wk) or not np.all(np.abs(ge - we) <= SAGE_TOL * (1 + np.abs(we))):
            raise RuntimeError("the 2-layer stack differs from its run on the twins")
        stack_err = max(stack_err, float(np.abs(ge - we).max()))
    if len(got) != 2:
        raise RuntimeError(f"the 2-layer stack gave {len(got)} windows")
    log(f"  2 stacked layers over 2 panes: keys equal to the run on the twins, embeddings within {SAGE_TOL} "
        f"(max |err| {stack_err:.6g})")

    # a fold over the snapshot: every vertex's degree, against np.bincount
    t_fold = time.perf_counter()
    recs = snapshot(src[:e], dst[:e]).fold_neighbors((0, 0), lambda acc, vid, nbr, val: (vid, acc[1] + 1)).collect()
    fold_s = time.perf_counter() - t_fold
    deg = np.bincount(np.concatenate([src[:e], dst[:e]]), minlength=c)
    ids = np.array([r[0] for r in recs])
    if len(ids) != np.count_nonzero(deg) or not np.array_equal(np.array([r[1] for r in recs]), deg[ids]):
        raise RuntimeError("fold_neighbors' degree count differs from np.bincount")
    log(f"  fold_neighbors degree count over one pane: {len(recs)} records equal to np.bincount in {fold_s:.2f} s")

    # times at the main path's shapes: the first (uniform) pane and the hub pane
    times = {label: sage_pane_times(dev, cycles_per_ms, label, src[w * e:(w + 1) * e], dst[w * e:(w + 1) * e],
                                    table, w_stacked, bias, parents, reps)
             for label, w, reps in (("uniform", 0, SAGE_REPS), ("hub", SAGE_PANES, SAGE_HUB_REPS))}

    widths = sage_width_times(dev, cycles_per_ms, src[:e], dst[:e])

    # where a window's time goes, stage by stage on the host's clock
    snap = snapshot(src[:e], dst[:e])
    pane = next(iter(snap._panes()))
    stages = dict.fromkeys(("host pad", "upload", "build_buckets call", "layer", "readback"), 0.0)
    reps = 3
    for _ in range(reps):
        t = time.perf_counter()
        sp, dp, _v, mp = snap._padded_pane_edges(pane)
        t1 = time.perf_counter()
        up = [torch.from_numpy(a).to(dev) for a in (sp, dp, mp)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        hb = [b for b in nbh.build_buckets(up[0], up[1], None, up[2]) if b.num_keys]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        kd, ed = model._layer_device(0, table, hb)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        kh, eh = gs._to_host(kd, ed)
        t5 = time.perf_counter()
        for k, dt_ in zip(stages, (t1 - t, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            stages[k] += dt_ / reps
        del kh, eh
    read_bytes = ed.numel() * 4 + kd.numel() * 4
    log("  one window stage by stage (host clock, synchronized): " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in stages.items())
        + f"; readback {read_bytes / stages['readback'] / 1e9:.3f} GB/s ({read_bytes} B of f32 embeddings and keys)")
    busy_ms = times["uniform"]["build"]["device_ms"] + times["uniform"]["layer"]["device_ms"]
    # a window's wall: the counted run's mean, and the second run's (its
    # pinned readback buffers already cached)
    per_window = wall / n_panes * 1e3
    warm_window = sum(again) / n_panes * 1e3
    log(f"  device compute per window ~{busy_ms:.3f} ms (the build's sort and kernels + the layer, held-stream times): "
        f"{busy_ms / per_window * 100:.2f}% of the counted run's {per_window:.2f} ms a window, "
        f"{busy_ms / warm_window * 100:.2f}% of the second run's {warm_window:.2f} ms")
    try:
        # the device's own rows: kernels and copies (aten:: rows repeat their time)
        rows_p = {k: v for k, v in profiler_device_us(lambda: [None for _ in model.run(snap)], 1).items()
                  if not k.startswith(("aten::", "Activity Buffer"))}
        total_us = sum(us * calls for us, calls in rows_p.values())
        copy_us = sum(us * calls for k, (us, calls) in rows_p.items() if k.startswith("Memcpy"))
        log(f"  torch.profiler, one window: device busy {total_us / 1e3:.3f} ms, of which copies "
            f"{copy_us / 1e3:.3f} ms: {total_us / 1e3 / per_window * 100:.2f}% of the counted run's window, "
            f"{total_us / 1e3 / warm_window * 100:.2f}% of the second run's (idle "
            f"{100 - total_us / 1e3 / warm_window * 100:.2f}%)")
        top = sorted(rows_p.items(), key=lambda r: -r[1][0] * r[1][1])[:8]
        names = [(re.search(r"(\w+)\(", k) or re.search(r"(.{0,40})", k)).group(1) for k, _ in top]
        log("  torch.profiler, top rows: " + "; ".join(
            f"{name} {us * calls:.1f} us" for name, (_, (us, calls)) in zip(names, top)))
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")
    uni, hubt = times["uniform"], times["hub"]
    return {
        "build": {**uni["build"], "launches": launches["build_buckets"], "err": max(build_err, sort_err),
                  "hub": hubt["build"]},
        "layer": {**uni["layer"], "launches": launches["sage_layer"], "err": layer_worst[0],
                  "chunked_err": layer_worst[1], "mean_rel_err": layer_worst[3], "stack_err": stack_err,
                  "oracle_err": max(oracle[0], hub[0]),
                  "hub": hubt["layer"], "widths_ms": widths},
        "windows_per_s": n_panes / wall, "edges_per_s": n_panes * e / wall, "embeddings_per_s": n_emb / wall,
    }


# ---------------------------------------------------------------------------
# phase 13: GraphSAGE training on the card


def backward_err(table, b, z, dz) -> tuple:
    """(max |kernel - twin| of dw, of db) of sage_layer_backward over one
    bucket, each within SAGE_BWD_RTOL * |A|^T |dH| (db: SAGE_BWD_DB_RTOL *
    sum |dH|), and two runs of the kernel equal bit for bit."""
    import torch

    from gelly_streaming_tpu_torch.ops import sage

    f_in, f_out = table.shape[1], z.shape[1]

    def run(fn):
        dw = torch.zeros((2 * f_in, f_out), dtype=torch.float32, device=z.device)
        db = torch.zeros((f_out,), dtype=torch.float32, device=z.device)
        return fn(table, b.keys, b.nbrs, b.valid, z, dz, dw, db)

    got, again, want = run(sage.sage_layer_backward), run(sage.sage_layer_backward), \
        run(sage.sage_layer_backward_plain)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise RuntimeError(f"sage_layer_backward gave two dw or db on one bucket (D={b.nbrs.shape[1]})")
    dh = torch.where(z > 0, dz.float(), 0.0).abs()
    a = sage.gather_mean_plain(table, b.keys, b.nbrs, b.valid).float().abs()
    errs = []
    for x, y, tol in zip(got, want, (SAGE_BWD_RTOL * (a.T @ dh) + 1e-6, SAGE_BWD_DB_RTOL * dh.sum(0) + 1e-6)):
        diff = (x - y).abs()
        if bool((diff > tol).any()):
            raise RuntimeError(f"sage_layer_backward differs from its twin past its bound (D={b.nbrs.shape[1]}, "
                               f"max |err| {float(diff.max()):.6g})")
        errs.append(float(diff.max()))
    return tuple(errs)


def step_grads_err(params, args) -> tuple:
    """(loss |rel err|, grads max |err|) of one step's loss and gradients
    through the kernels (SageLayerFn) against autograd of the plain twin on
    the same inputs, on the card, within TRAIN_LOSS_RTOL and
    TRAIN_GRAD_RTOL / TRAIN_GRAD_ATOL."""
    import torch

    from gelly_streaming_tpu_torch.library import graphsage as gs
    from gelly_streaming_tpu_torch.ops import sage

    loss = gs.sage_loss(params, *args)
    grads = torch.autograd.grad(loss, list(params))
    loss_p = gs._loss(sage.sage_layer_plain, params, *args)
    grads_p = torch.autograd.grad(loss_p, list(params))
    loss, loss_p = float(loss.detach()), float(loss_p.detach())
    rel = abs(loss - loss_p) / abs(loss_p)
    worst = 0.0
    for g, w in zip(grads, grads_p):
        diff = (g - w).abs()
        if bool((diff > TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * w.abs()).any()) or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"a step's gradient differs from the twin's autograd (max |err| "
                               f"{float(diff.max()):.6g})")
        worst = max(worst, float(diff.max()))
    if rel > TRAIN_LOSS_RTOL:
        raise RuntimeError(f"a step's loss {loss} differs from the twin's {loss_p}")
    return rel, worst


def train_profile(fn, reps: int, warmup: bool = True, require=()):
    """(device busy ms per call of ``fn`` by torch.profiler, its top six
    device rows as (name, ms per call)); (None, []) if the profiler
    fails, and (None, top) if it kept no row of a kernel named in
    ``require`` (the profile lost the path's kernels, so its busy time is
    not the path's).  Only the device's own rows (kernels, copies, sets)
    count: the autograd and optimizer ranges, and their annotations on the
    device's timeline, also carry the device time of what they launch.
    ``fn`` runs once before the profiled calls unless ``warmup`` is
    False."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        if warmup:
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = {}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0)
            device_row = getattr(evt, "device_type", None) == DeviceType.CUDA
            if device_row and not getattr(evt, "is_user_annotation", False) and us and evt.count:
                rows[evt.key] = (us / evt.count, evt.count)
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")
        return None, []
    def short(key):
        return re.split(r"[<(]", key.replace("(anonymous namespace)::", "").removeprefix("void "))[0] \
            .split("::")[-1].strip()[:40]

    ranked = sorted(rows.items(), key=lambda r: -r[1][0] * r[1][1])
    top = [(short(k), round(us * calls / reps / 1e3, 4)) for k, (us, calls) in ranked[:6]]
    missing = set(require) - {short(k) for k in rows}
    if missing:
        log(f"  torch.profiler kept no row of {sorted(missing)} (rows {top}): busy time not measured")
        return None, top
    return sum(us * calls for us, calls in rows.values()) / reps / 1e3, top


def parent_sage_calls(lib):
    """(layer, backward): the parent's sage_layer and sage_layer_backward
    C calls over ``lib``, as their wrappers made them (the same scratch
    and partial sums): layer(table, keys, nbrs, valid, w, bias, out) and
    backward(table, keys, nbrs, valid, z, dz, dw, db)."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda, sage

    def layer(table, keys, nbrs, valid, w, bias, out):
        (c, f_in), (k, d), f_out = table.shape, nbrs.shape, w.shape[1]
        nchunks, part, cnt = sage._partials(table, k, d)
        _cuda.check(lib.sage_layer_launch(
            table.data_ptr(), c, f_in, keys.data_ptr(), nbrs.data_ptr(), valid.data_ptr(), k, d, w.data_ptr(),
            bias.data_ptr(), f_out, out.data_ptr(), sage._CHUNK, nchunks, sage._ptr(part), sage._ptr(cnt),
            torch.cuda.current_stream(table.device).cuda_stream), "parent sage_layer_launch")
        return out

    def backward(table, keys, nbrs, valid, z, dz, dw, db):
        (c, f_in), (k, d), f_out = table.shape, nbrs.shape, z.shape[1]
        nbytes = lib.sage_layer_backward_scratch_bytes(f_in, f_out)
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=table.device)
        nchunks, part, cnt = sage._partials(table, k, d)
        _cuda.check(lib.sage_layer_backward_launch(
            table.data_ptr(), c, f_in, keys.data_ptr(), nbrs.data_ptr(), valid.data_ptr(), k, d, z.data_ptr(),
            dz.data_ptr(), f_out, dw.data_ptr(), db.data_ptr(), sage._CHUNK, nchunks, sage._ptr(part),
            sage._ptr(cnt), scratch.data_ptr(), nbytes, torch.cuda.current_stream(table.device).cuda_stream),
            "parent sage_layer_backward_launch")
        return dw, db

    return layer, backward


def ptxas_report(log: str, pattern: str) -> dict:
    """{mangled kernel name: {"registers", "stack", "spill_stores",
    "spill_loads"}} of the entry functions whose name contains
    ``pattern``, from nvcc's ``-Xptxas -v`` log (their shared memory is
    dynamic: the launch asks for it, ptxas does not see it)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if pattern in m.group(1) else None
        elif cur and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                                     line)):
            out.setdefault(cur, {}).update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(cur, {})["registers"] = int(m[1])
    return out


def phase_train(dev, cycles_per_ms: float, parent=None, sage_log: str = "", split_cu=None) -> dict:
    """Phase 13: GraphSAGE training at F = 128 through sage_init_train,
    sample_pairs and sage_train_step: (a) the JAX bench's batch, 20 steps;
    (b) every bucket of phase 12's first uniform pane (slice(ALL) ->
    build_buckets), one step a bucket for TRAIN_PASSES passes, then the hub
    pane's buckets once, launches counted; (c) sage_layer_backward against
    its twin on every bucket of (a) and (b) and bit for bit across runs, a
    whole step against the twin's autograd; (d) the backward's times over
    the pane's buckets and their contexts, its kernels' split by
    torch.profiler and their ptxas report (``sage_log``: sage.cu's build
    log), the forward over the contexts, and with ``parent`` (a loaded
    sage.cu with the ece4aae C interface) the parent's backward and
    forward in turns with the current ones; with ``split_cu`` ({part:
    source}, BACKWARD_SPLIT's variants) each variant's backward timed
    beside the current one."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.core.types import EdgeDirection
    from gelly_streaming_tpu_torch.library import graphsage as gs
    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
    from gelly_streaming_tpu_torch.ops import sage

    f = SAGE_FEATURES
    out = {}

    # (a) the bench's batch (bench.py's seed 9 and draws)
    rng = np.random.default_rng(9)
    k, d, c = TRAIN_BENCH_K, TRAIN_BENCH_D, TRAIN_BENCH_C
    feats = rng.normal(size=(c, f)).astype(np.float32)
    keys = rng.integers(0, c, k).astype(np.int32)
    nbrs = rng.integers(0, c, (k, d)).astype(np.int32)
    valid = rng.random((k, d)) < 0.8
    table = torch.from_numpy(feats).to(dev).to(torch.bfloat16)
    tk, tn, tv = to_dev((keys, nbrs, valid), dev)
    state = gs.sage_init_train(f, f, lr=TRAIN_LR, generator=torch.Generator().manual_seed(1), device=dev)
    pairs = gs.sample_pairs(torch.Generator(device=dev).manual_seed(2), tn, tv, c)
    args = (table, tk, tn, tv, *pairs)
    bench_step_err = step_grads_err(state.params, args)
    times, losses = [], []
    for _ in range(TRAIN_BENCH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = gs.sage_train_step(state, *args)
        losses.append(float(loss))  # synchronizes
        times.append(time.perf_counter() - t0)
    p50 = float(np.percentile(times[1:], 50)) * 1e3
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise RuntimeError(f"the bench batch's loss did not fall: {losses}")
    busy, top = train_profile(lambda: gs.sage_train_step(state, *args), 5)
    idle = None if busy is None else 100 * (1 - busy / p50)
    log(f"  (a) the bench's batch (K = {k}, D = {d}, p = 0.8, {c} vertices, F = {f}, lr {TRAIN_LR}): "
        f"{TRAIN_BENCH_STEPS} steps, step p50 {p50:.4f} ms (host clock, synchronized; the first "
        f"{times[0] * 1e3:.2f} ms), {k / p50 * 1e3:.6g} pairs/s, loss {losses[0]:.6g} -> {losses[-1]:.6g}; "
        f"torch.profiler: device busy {busy if busy is None else round(busy, 4)} ms a step, idle "
        f"{idle if idle is None else round(idle, 2)}%; a step against the twin's autograd: loss rel err "
        f"{bench_step_err[0]:.3g}, grads max |err| {bench_step_err[1]:.3g}; top device rows a step: {top}")
    z = sage.sage_layer(table, tk, tn, tv, gs._stacked(gs._as_bf16(state.params)).detach(),
                        state.params.bias.detach().to(torch.bfloat16))
    dz = torch.randn(z.shape, generator=torch.Generator(device=dev).manual_seed(3), device=dev).to(torch.bfloat16)
    bench_bucket = nbh.NeighborhoodBucket(tk, tn, None, tv, k)
    bench_err = backward_err(table, bench_bucket, z, dz)
    out["bench"] = {"step_p50_ms": p50, "first_step_ms": times[0] * 1e3, "pairs_per_s": k / p50 * 1e3,
                    "loss_first": losses[0], "loss_last": losses[-1], "device_busy_ms": busy, "idle_pct": idle,
                    "step_loss_rel_err": bench_step_err[0], "step_grad_err": bench_step_err[1],
                    "backward_err": bench_err}
    del table, args, pairs, z, dz

    # (b) the main path at realistic scale: a uniform pane's buckets, then the hub pane's
    c, e = SAGE_VERTICES, SAGE_PANE_EDGES
    src, dst = sage_stream_arrays()
    table = torch.randn((c, f), generator=torch.Generator(device=dev).manual_seed(4), device=dev).to(torch.bfloat16)
    cfg = StreamConfig(vertex_capacity=c, batch_size=e, ingest_window_edges=e)

    def buckets(w):  # pane w's non-empty buckets, through slice(ALL)
        return list(EdgeStream.from_arrays(src[w * e:(w + 1) * e], dst[w * e:(w + 1) * e], cfg, device=dev).slice(
            WINDOW_MS, EdgeDirection.ALL)._neighborhood_panes())

    state = gs.sage_init_train(f, f, lr=TRAIN_LR, generator=torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    nbh.reset_launches()
    sage.reset_launches()
    t_run = time.perf_counter()
    hoods = buckets(0)
    step_s = [0.0] * len(hoods)
    pass_loss, sample_s, steps = [], 0.0, 0
    for _ in range(TRAIN_PASSES):
        total = 0.0
        for i, h in enumerate(hoods):
            t0 = time.perf_counter()
            pairs = gs.sample_pairs(gen, h.nbrs, h.valid, c)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, loss = gs.sage_train_step(state, table, h.keys, h.nbrs, h.valid, *pairs)
            total += float(loss) * h.num_keys  # synchronizes
            step_s[i] += time.perf_counter() - t1
            sample_s += t1 - t0
            steps += 1
        pass_loss.append(total / sum(h.num_keys for h in hoods))
    hub = buckets(SAGE_PANES)
    hub_losses = []
    for h in hub:
        pairs = gs.sample_pairs(gen, h.nbrs, h.valid, c)
        state, loss = gs.sage_train_step(state, table, h.keys, h.nbrs, h.valid, *pairs)
        hub_losses.append(float(loss))
        steps += 1
    run_s = time.perf_counter() - t_run
    launches = {"build_buckets": nbh.LAUNCHES["build_buckets"], "sage_layer": sage.LAUNCHES["sage_layer"],
                "sage_layer_backward": sage.LAUNCHES["sage_layer_backward"]}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if launches != {"build_buckets": 2, "sage_layer": 2 * steps, "sage_layer_backward": 2 * steps}:
        raise RuntimeError(f"training launched {launches} for {steps} steps over 2 panes")
    if not all(np.isfinite(pass_loss + hub_losses)) or pass_loss[-1] >= pass_loss[0]:
        raise RuntimeError(f"the pane's loss did not fall over the passes: {pass_loss}")
    rows = sum(h.num_keys for h in hoods)
    train_s = sum(step_s)

    def one_pass():
        nonlocal state
        for h in hoods:
            state, _ = gs.sage_train_step(state, table, h.keys, h.nbrs, h.valid,
                                          *gs.sample_pairs(gen, h.nbrs, h.valid, c))

    pass_busy, pass_top = train_profile(one_pass, 1)
    log(f"  (b) uniform pane 0 ({rows} keys in {len(hoods)} buckets, D {[h.nbrs.shape[1] for h in hoods]}, "
        f"{c} vertices, F = {f}): {TRAIN_PASSES} passes of one step a bucket; step ms a bucket "
        f"{[round(x / TRAIN_PASSES * 1e3, 3) for x in step_s]}, a pass {train_s / TRAIN_PASSES * 1e3:.3f} ms, "
        f"{rows * TRAIN_PASSES / train_s:.6g} pairs/s (steps alone; sample_pairs {sample_s * 1e3:.2f} ms in all); "
        f"loss a pass (row-weighted) {[round(x, 5) for x in pass_loss]}; then the hub pane's {len(hub)} buckets "
        f"once (D up to {max(h.nbrs.shape[1] for h in hub)}): losses {[round(x, 4) for x in hub_losses]}; the whole "
        f"run {run_s:.3f} s with the two slice() builds; peak device memory {peak_gb:.3f} GB; launches {launches}; "
        f"torch.profiler, one more pass: device busy {pass_busy if pass_busy is None else round(pass_busy, 4)} ms "
        f"({'-' if pass_busy is None else round(100 * (1 - pass_busy / (train_s / TRAIN_PASSES * 1e3)), 2)}% idle "
        f"against a counted pass), top rows {pass_top}")

    # (c) the kernel against its twin on every bucket, the trained weights' z
    w = gs._stacked(gs._as_bf16(state.params)).detach()
    bias = state.params.bias.detach().to(torch.bfloat16)
    zs, dzs = [], []
    worst = [0.0, 0.0]
    g3 = torch.Generator(device=dev).manual_seed(6)
    for h in hoods + hub:
        z = sage.sage_layer(table, h.keys, h.nbrs, h.valid, w, bias)
        dz = torch.randn(z.shape, generator=g3, device=dev).to(torch.bfloat16)
        worst = list(map(max, worst, backward_err(table, h, z, dz)))
        if len(zs) < len(hoods):
            zs.append(z)
            dzs.append(dz)
    big = max(hoods, key=lambda h: h.num_keys)
    pane_step_err = step_grads_err(state.params, (table, big.keys, big.nbrs, big.valid,
                                                  *gs.sample_pairs(gen, big.nbrs, big.valid, c)))
    log(f"  (c) sage_layer_backward within {SAGE_BWD_RTOL} * |A|^T |dH| (db: {SAGE_BWD_DB_RTOL} * sum |dH|) of its "
        f"twin on the bench's bucket and all {len(hoods) + len(hub)} buckets of both panes, equal bit for bit "
        f"across two runs: max |err| dw {max(worst[0], bench_err[0]):.6g}, db {max(worst[1], bench_err[1]):.6g}; "
        f"a step on the largest bucket ({big.num_keys} keys) against the twin's autograd: loss rel err "
        f"{pane_step_err[0]:.3g}, grads max |err| {pane_step_err[1]:.3g}")

    # (d) the backward over the uniform pane's buckets: device only, bound, twin, library
    dws = torch.zeros((2 * f, f), dtype=torch.float32, device=dev)
    dbs = torch.zeros((f,), dtype=torch.float32, device=dev)

    def backward():
        for h, z, dz in zip(hoods, zs, dzs):
            sage.sage_layer_backward(table, h.keys, h.nbrs, h.valid, z, dz, dws, dbs)

    b_ms, b_us = device_ms(backward, SAGE_REPS, cycles_per_ms)
    b_events = cuda_ms(backward, SAGE_REPS)
    plain_ms = cuda_ms(lambda: [sage.sage_layer_backward_plain(table, h.keys, h.nbrs, h.valid, z, dz, dws, dbs)
                                for h, z, dz in zip(hoods, zs, dzs)], 2, 1)
    slots = sum(h.nbrs.numel() for h in hoods)
    distinct = int(torch.unique(torch.cat([h.keys for h in hoods] + [h.nbrs[h.valid] for h in hoods])).numel())
    # each input once: ids and flags, each distinct table row a key or a
    # valid neighbor names, z and dz; dw and db read and written once
    bytes_ = 4 * rows + 5 * slots + 2 * f * distinct + 2 * 2 * f * rows + 2 * 4 * (2 * f * f + f)
    ops = 2 * rows * 2 * f * f
    bytes_ms, ops_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    # the yardstick: embedding_bag(mode="mean") over the valid neighbors,
    # then one product A^T dH (bf16, the tensor cores); on no path
    flat = torch.cat([h.nbrs[h.valid] for h in hoods]).long()
    offs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(torch.cat([h.valid.sum(1) for h in hoods]), 0)[:-1]])
    keys_all = torch.cat([h.keys for h in hoods]).long()
    bag = torch.nn.functional.embedding_bag(flat, table, offs, mode="mean")
    xm_t = torch.cat([table[keys_all], bag.to(torch.bfloat16)], 1).t()
    dh = torch.cat([torch.where(z > 0, dz, 0) for z, dz in zip(zs, dzs)])
    bag_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(flat, table, offs, mode="mean"), SAGE_REPS)
    mm_ms = cuda_ms(lambda: torch.mm(xm_t, dh), SAGE_REPS)
    ref = torch.zeros_like(dws)
    for h, z, dz in zip(hoods, zs, dzs):
        sage.sage_layer_backward(table, h.keys, h.nbrs, h.valid, z, dz, ref, torch.zeros_like(dbs))
    lib_err = float((torch.mm(xm_t, dh).float() - ref).abs().max())
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"  (d) sage_layer_backward over the uniform pane's {len(hoods)} buckets ({rows} rows, {slots} slots), "
        f"device only: {b_ms:.4f} ms, host enqueue {b_us:.1f} us ({b_us / len(hoods):.2f} us a call); back-to-back "
        f"events {b_events:.4f} ms; bound {bound:.5f} ms ({bound_by}: {bytes_} B, {distinct} distinct table rows, "
        f"{bytes_ms:.5f} ms; {ops} bf16 operations, {ops_ms:.5f} ms), {b_ms / bound:.3f}x it; plain twin "
        f"{plain_ms:.3f} ms; yardstick embedding_bag(mode='mean') {bag_ms:.4f} ms + mm(A^T, dH) {mm_ms:.4f} ms = "
        f"{bag_ms + mm_ms:.4f} ms (max |diff| of its dw to the kernel's {lib_err:.4g})")
    # the step's other backward call: the contexts, 2K rows a bucket over an
    # empty neighborhood (a self row each, the W_nbr half's product all 0)
    ctx = []
    for h in hoods:
        ids = torch.cat(gs.sample_pairs(gen, h.nbrs, h.valid, c)[::2])
        empty = ids.new_empty((ids.shape[0], 0))
        cz = sage.sage_layer(table, ids, empty, empty.bool(), w, bias)
        ctx.append((ids, empty, empty.bool(), cz, torch.randn(cz.shape, generator=g3, device=dev).to(torch.bfloat16)))

    def ctx_backward():
        for ids, empty, none, cz, cdz in ctx:
            sage.sage_layer_backward(table, ids, empty, none, cz, cdz, dws, dbs)

    c_ms, c_us = device_ms(ctx_backward, SAGE_REPS, cycles_per_ms)
    c_rows = 2 * rows
    c_distinct = int(torch.unique(torch.cat([x[0] for x in ctx])).numel())
    # the self half alone: a self row, z and dz a row; dw's W_self rows and
    # db read and written once; the product x_self^T dH
    c_bytes = 4 * c_rows + 2 * f * c_distinct + 2 * 2 * f * c_rows + 2 * 4 * (f * f + f)
    c_bound = max(c_bytes / HBM_BYTES_PER_S * 1e3, 2 * c_rows * f * f / BF16_FLOPS_PER_S * 1e3)
    log(f"  (d) sage_layer_backward over the contexts of the pane's {len(hoods)} steps ({c_rows} rows, D = 0), "
        f"device only: {c_ms:.4f} ms, host enqueue {c_us / len(ctx):.2f} us a call; bound {c_bound:.5f} ms "
        f"({c_bytes} B, {c_distinct} distinct table rows; the self half's product), {c_ms / c_bound:.3f}x it")
    # the kernels' split by torch.profiler (the reduce's share), and what
    # ptxas reported for the tensor-core instantiations
    split = {}
    for label, fn in (("buckets", backward), ("contexts", ctx_backward)):
        busy_ms, top = train_profile(fn, 5)
        split[label] = {"device_busy_ms": busy_ms, "rows": top,
                        "reduce_share": None if not busy_ms else
                        sum(ms for name, ms in top if "reduce" in name) / busy_ms}
        log(f"  (d) torch.profiler over the {label}' backward: device busy {busy_ms} ms, rows {top}; the reduce's "
            f"share {split[label]['reduce_share']}")
    ptxas = ptxas_report(sage_log, "sage_backward_wgmma_kernel")
    log(f"  (d) ptxas for sage_backward_wgmma_kernel (ILb0: [x_self | mean], ILb1: the self half): {ptxas}")
    # the forward over the same contexts (its D = 0 skip of the mean half)
    ctx_out = [torch.empty_like(x[3]) for x in ctx]

    def ctx_forward():
        for (ids, empty, none, _cz, _cdz), o in zip(ctx, ctx_out):
            sage.sage_layer(table, ids, empty, none, w, bias, out=o)

    f_ms, _ = device_ms(ctx_forward, SAGE_REPS, cycles_per_ms)
    log(f"  (d) sage_layer over the same contexts (D = 0), device only: {f_ms:.4f} ms")
    turns = {}
    if parent is not None:
        p_layer, p_backward = parent_sage_calls(parent)
        got = [torch.zeros_like(dws), torch.zeros_like(dws)]
        for h, z, dz in zip(hoods, zs, dzs):
            p_backward(table, h.keys, h.nbrs, h.valid, z, dz, got[0], torch.zeros_like(dbs))
            sage.sage_layer_backward(table, h.keys, h.nbrs, h.valid, z, dz, got[1], torch.zeros_like(dbs))
        rel = float((got[0] - got[1]).abs().max() / got[1].abs().max())
        if not rel < 2.0 ** -7:
            raise RuntimeError(f"the parent's backward and sage_layer_backward disagree (max rel {rel:.3g})")

        def p_backward_all():
            for h, z, dz in zip(hoods, zs, dzs):
                p_backward(table, h.keys, h.nbrs, h.valid, z, dz, dws, dbs)

        def p_ctx_backward():
            for ids, empty, none, cz, cdz in ctx:
                p_backward(table, ids, empty, none, cz, cdz, dws, dbs)

        def p_ctx_forward():
            for (ids, empty, none, _cz, _cdz), o in zip(ctx, ctx_out):
                p_layer(table, ids, empty, none, w, bias, o)

        turns = {
            "buckets": in_turns("uniform pane's buckets, the backward (parent: ece4aae, the CUDA cores)",
                                p_backward_all, backward, SAGE_REPS, cycles_per_ms),
            "contexts": in_turns("the contexts, the backward (parent: ece4aae)", p_ctx_backward, ctx_backward,
                                 SAGE_REPS, cycles_per_ms),
            "contexts_forward": in_turns("the contexts, the forward sage_layer (parent: ece4aae)", p_ctx_forward,
                                         ctx_forward, SAGE_REPS, cycles_per_ms),
            "max_rel_diff": rel,
        }
    for part, path in (split_cu or {}).items():
        if not _cuda._target(path).exists():  # its build failed in phase 1
            log(f"  (d) split: the variant without {part} did not build; skipped")
            continue
        _, v_backward = parent_sage_calls(load_baseline(path, PARENT_SIGNATURES["sage_backward"]))

        def v_buckets():
            for h, z, dz in zip(hoods, zs, dzs):
                v_backward(table, h.keys, h.nbrs, h.valid, z, dz, dws, dbs)

        def v_contexts():
            for ids, empty, none, cz, cdz in ctx:
                v_backward(table, ids, empty, none, cz, cdz, dws, dbs)

        v = {"buckets_ms": device_ms(v_buckets, SAGE_REPS, cycles_per_ms)[0],
             "contexts_ms": device_ms(v_contexts, SAGE_REPS, cycles_per_ms)[0]}
        turns.setdefault("split", {})[part] = v
        log(f"  (d) split: without {part}: buckets {v['buckets_ms']:.4f} ms, contexts {v['contexts_ms']:.4f} ms "
            f"(the kernel as committed: {b_ms:.4f}, {c_ms:.4f})")
    out["backward"] = {"ms": b_events, "device_ms": b_ms, "host_us": b_us, "host_us_a_call": b_us / len(hoods),
                       "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "bytes_ms": bytes_ms,
                       "ops_ms": ops_ms, "ratio_to_bound": b_ms / bound, "library_ms": bag_ms + mm_ms,
                       "embedding_bag_ms": bag_ms, "mm_ms": mm_ms,
                       "launches": launches["sage_layer_backward"],
                       "err": max(worst[0], worst[1], bench_err[0], bench_err[1]),
                       "dw_err": max(worst[0], bench_err[0]), "db_err": max(worst[1], bench_err[1]),
                       "contexts": {"device_ms": c_ms, "host_us_a_call": c_us / len(ctx), "bound_ms": c_bound,
                                    "ratio_to_bound": c_ms / c_bound, "rows": c_rows, "forward_device_ms": f_ms},
                       "split": split, "ptxas": ptxas, **({"turns": turns} if turns else {})}
    out["pane"] = {"rows": rows, "buckets": len(hoods), "step_ms": [x / TRAIN_PASSES * 1e3 for x in step_s],
                   "pass_ms": train_s / TRAIN_PASSES * 1e3, "pairs_per_s": rows * TRAIN_PASSES / train_s,
                   "pass_loss": pass_loss, "hub_losses": hub_losses, "peak_gb": peak_gb, "launches": launches,
                   "pass_device_busy_ms": pass_busy,
                   "step_loss_rel_err": pane_step_err[0], "step_grad_err": pane_step_err[1]}
    return out


def compress_states(rng, nodes: int) -> dict:
    """The states phase 11 compresses: the main path's flat init_parent, a
    uf_forest, and the path a reversed insertion leaves unflattened
    (parent[v] = v - 1: depth nodes - 1)."""
    path = np.maximum(np.arange(nodes, dtype=np.int32) - 1, 0)
    return {"flat": np.arange(nodes, dtype=np.int32), "uf_forest": uf_forest(rng, nodes), "path": path}


def phase_turns(dev, cycles_per_ms: float, parent_cu: dict, fold_split_cu: dict, dd: dict, cc: dict,
                bp: dict) -> dict:
    """Phase 11: degree_fold and compress (and the union calls around the
    latter) in turns with the parent commit's builds on the main path's
    inputs (parent, current, current, parent; device only, on the held
    stream), and the split of the current degree_fold (FOLD_SPLIT)."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda, degrees
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    libs = {k: load_baseline(path, PARENT_SIGNATURES[k]) for k, path in parent_cu.items()}
    out = {}

    def turns(label, old_fn, new_fn, reps=UF_REPS):
        got = []
        for tag, fn in (("parent", old_fn), ("current", new_fn), ("current", new_fn), ("parent", old_fn)):
            got.append((tag, *fn(reps)))
        log(f"  {label}: " + "; ".join(f"{tag} {ms:.4f} ms" for tag, ms, _ in got))
        old, old_us = ((got[0][k] + got[3][k]) / 2 for k in (1, 2))
        new, new_us = ((got[1][k] + got[2][k]) / 2 for k in (1, 2))
        log(f"    mean parent {old:.4f} ms, current {new:.4f} ms, {old / new:.2f}x; host enqueue a call "
            f"parent {old_us:.2f} us, current {new_us:.2f} us")
        return {"parent_ms": old, "current_ms": new, "turns": [ms for _, ms, _ in got],
                "parent_host_us": old_us, "current_host_us": new_us}

    if "degrees" in libs:
        old_fold = parent_degree_fold(libs["degrees"])
        acc = torch.zeros(CC_VERTICES, dtype=torch.int32, device=dev)
        for name, (s, d) in dd["fold"]["turns_batches"].items():
            if not torch.equal(old_fold(acc.clone(), s, d), degrees.degree_fold(acc.clone(), s, d)):
                raise RuntimeError(f"the parent's degree_fold and the current one disagree on the {name} batch")
            held = lambda fn: lambda reps: device_ms(fn, reps, cycles_per_ms)  # noqa: E731
            out[f"fold_{name}"] = turns(f"degree_fold, the {name} batch ({s.shape[0]} edges)",
                                        held(lambda s=s, d=d: old_fold(acc, s, d)),
                                        held(lambda s=s, d=d: degrees.degree_fold(acc, s, d)))
        # the C calls alone, each build behind the same lean wrapper: the host
        # enqueue without the port's Python checks
        cur_fold = parent_degree_fold(_cuda.library("degrees.cu"))
        s, d = dd["fold"]["turns_batches"]["uniform"]
        out["fold_c_call"] = turns("degree_fold's C call alone, the uniform batch",
                                   held(lambda: old_fold(acc, s, d)), held(lambda: cur_fold(acc, s, d)))
        split = {}
        for part, path in fold_split_cu.items():
            if not _cuda._target(path).exists():  # its build failed in phase 1
                continue
            fold = parent_degree_fold(load_baseline(path, PARENT_SIGNATURES["degrees"]))
            split[part] = {name: device_ms(lambda s=s, d=d: fold(acc, s, d), UF_REPS, cycles_per_ms)[0]
                           for name, (s, d) in dd["fold"]["turns_batches"].items()}
            log(f"  degree_fold without {part}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in split[part].items()))
        out["fold_split"] = split
    if "unionfind" in libs:
        none = torch.zeros(0, dtype=torch.int32, device=dev)
        old_call = parent_union_fold(libs["unionfind"], False)
        rng = np.random.default_rng(11)
        for nodes in (CC_VERTICES, 2 * CC_VERTICES):
            for name, arr in compress_states(rng, nodes).items():
                state = torch.from_numpy(arr).to(dev)
                want = uf.compress_plain(state)
                got_old = old_call(state.clone(), None, none, none)[0]
                got_new = uf.compress(state.clone())
                if not (torch.equal(got_old, want) and torch.equal(got_new, want)):
                    raise RuntimeError(f"compress of the {name} state over {nodes} nodes differs from the twin")
                reps = UF_REPS if name == "flat" else 5
                out[f"compress_{name}_{nodes}"] = turns(
                    f"compress, the {name} state over {nodes} nodes (a call with no edges)",
                    lambda r, st=state: copies_device_ms(lambda p: old_call(p, None, none, none), st.clone, r,
                                                         cycles_per_ms),
                    lambda r, st=state: copies_device_ms(uf.compress, st.clone, r, cycles_per_ms), reps)
        cur_call = parent_union_fold(_cuda.library("unionfind.cu"), False)
        st, edges = cc["turns"]["late"], cc["turns"]["late_batch"]
        out["CC_late_c_call"] = turns(
            "CC union's C call alone, late batch (the state declared flat)",
            lambda r: fold_device_ms(lambda p, sn, s, d: old_call(p, sn, s, d, True), *st, *edges, r, cycles_per_ms),
            lambda r: fold_device_ms(lambda p, sn, s, d: cur_call(p, sn, s, d, True), *st, *edges, r, cycles_per_ms))
        for name, res, parity, fold in (("CC", cc, False, uf.union_edges_with_seen),
                                        ("parity", bp, True, uf.parity_union_edges_with_seen)):
            t = res["turns"]
            old_fold = parent_union_fold(libs["unionfind"], parity)
            for batch, state, edges, flat in (("first", t["init"], t["first_batch"], False),
                                              ("late", t["late"], t["late_batch"], True)):
                want = fold(uf.mark_flat(state[0].clone()) if flat else state[0].clone(), state[1].clone(), *edges)
                got = old_fold(state[0].clone(), state[1].clone(), *edges, flat)
                if not (torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])):
                    raise RuntimeError(f"the parent's {name} union and the current one disagree ({batch} batch)")
                out[f"{name}_{batch}"] = turns(
                    f"{name} union call, {batch} batch",
                    lambda reps, st=state, e=edges, fl=flat: fold_device_ms(
                        lambda p, sn, s, d: old_fold(p, sn, s, d, fl), *st, *e, reps, cycles_per_ms),
                    lambda reps, st=state, e=edges, fl=flat: fold_device_ms(fold, *st, *e, reps, cycles_per_ms, flat=fl))
    return out


# ---------------------------------------------------------------------------
# phase 14: the asynchronous window pipeline, the superbatch planes and
# csr_triangles

ASYNC_WINDOWS = 100  # bench.py:310-395 (_async_window_bench): 100 windows
ASYNC_WIN_EDGES = 1 << 13  # of 2^13 edges
ASYNC_CAPACITY = 1 << 16  # over 2^16 vertices
ASYNC_DEPTH = 4  # the bench's GELLY_ASYNC_WINDOWS default
WIDE_WINDOWS = 16  # the CC bench's 50 batches of 2^21, cut to 16 windows for time
WIDE_WIN_EDGES = 1 << 21
SB_K = 4
SNAP_PANES = 4  # phase 12's uniform panes through reduce_on_edges
CSR_REPS = {"group": 20, "csr_window": 20, "hub": 5}  # the parent: ~16-26 launches a call, under ~1000 held


def cc_window_stream(src, dst, t_ms, batch: int, cfg, dev):
    """An event-time stream over host arrays in batches of ``batch`` edges
    made on the card, as the bench's ``EdgeBatch.from_arrays`` factory."""
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.core.types import EdgeBatch

    def factory():
        for i in range(0, len(src), batch):
            yield EdgeBatch.from_arrays(src[i:i + batch], dst[i:i + batch], time=t_ms[i:i + batch], device=dev)

    return EdgeStream.from_batches(factory, cfg, device=dev)


def cc_window_run(stream):
    """(seconds, every emission's parent on the host): the bench's
    materializing consumer."""
    import torch
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [rec[0].parent.cpu().numpy() for rec in ConnectedComponents(window_ms=100).run(stream)]
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def cc_planes(dev, label: str, src, dst, win_edges: int, capacity: int, configs: dict) -> dict:
    """Each config of ``configs`` (name -> StreamConfig fields beyond the
    base) over the same windows: a warm-up run, then a counted one; every
    emission's parent equal to the first config's; union_kernel launched.
    Returns {name: (seconds, pipeline stats, launches)} and the parents."""
    import dataclasses
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.ops import unionfind as uf
    from gelly_streaming_tpu_torch.utils import metrics

    n = len(src)
    t_ms = (np.arange(n) // win_edges) * 100 + 50  # 100 ms tumbling windows
    batch = win_edges // 2  # batches never align with window cuts
    base = StreamConfig(vertex_capacity=capacity, batch_size=batch)
    runs, first = {}, None
    for name, kw in configs.items():
        cfg = dataclasses.replace(base, **kw)
        cc_window_run(cc_window_stream(src, dst, t_ms, batch, cfg, dev))  # warm-up
        metrics.reset_pipeline_stats()
        uf.reset_launches()
        secs, out = cc_window_run(cc_window_stream(src, dst, t_ms, batch, cfg, dev))
        launches = uf.LAUNCHES["union_kernel"]
        stats = metrics.pipeline_stats()
        if launches <= 0:
            raise RuntimeError(f"{label} {name}: union_kernel was not launched")
        if first is None:
            first = out
        elif len(out) != len(first) or not all(np.array_equal(a, b) for a, b in zip(out, first)):
            raise RuntimeError(f"{label} {name}: emissions differ from {next(iter(configs))}'s")
        runs[name] = (secs, stats, launches)
        log(f"  {label} {name}: {len(out)} windows in {secs:.4f} s, {len(out) / secs:.2f} windows/s, "
            f"{n / secs:.6g} edges/s; union_kernel launches {launches}; dispatch stall "
            f"{stats['pipeline_dispatch_stall_s']} s, drain stall {stats['pipeline_drain_stall_s']} s, "
            f"in-flight high water {stats['pipeline_inflight_high_water']}")
    return runs


def csr_oracle(src, dst) -> int:
    """Triangles of an edge list by scipy: the edges oriented from the
    lower (degree, id) rank to the higher, sum((A+ @ A+) * A+), which
    equals sum((A @ A) * A) / 6 without forming A @ A (a hub of 2^17
    neighbors would make it ~2^34 entries)."""
    import scipy.sparse as sp

    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    keep = lo != hi
    pairs = np.unique(np.stack([lo[keep], hi[keep]], axis=1), axis=0)
    verts, inv = np.unique(pairs.ravel(), return_inverse=True)
    a, b = inv.reshape(-1, 2).T
    n = len(verts)
    deg = np.bincount(np.concatenate([a, b]), minlength=n)
    pos = np.empty(n, np.int64)
    pos[np.lexsort((np.arange(n), deg))] = np.arange(n)
    fwd = pos[a] < pos[b]
    ap = sp.csr_matrix((np.ones(len(a), np.int64), (np.where(fwd, a, b), np.where(fwd, b, a))), shape=(n, n))
    return int((ap @ ap).multiply(ap).sum())


def sampled_addmm_ms(dev, u, v, ok, n_v: int, want_total: int):
    """``torch.sparse.sampled_addmm`` over the block-diagonal adjacency of
    the panes (both directions): (A @ A) at A's nonzeros in one call, whose
    sum / 6 is the panes' triangles.  (ms, None) or (None, the reason)."""
    import torch

    k = u.shape[0]
    rows = [torch.cat([u[p][ok[p]], v[p][ok[p]]]).long() + p * n_v for p in range(k)]
    cols = [torch.cat([v[p][ok[p]], u[p][ok[p]]]).long() + p * n_v for p in range(k)]
    size = k * n_v
    try:
        a = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                    torch.ones(sum(len(r) for r in rows), device=dev), (size, size))
        a = a.coalesce().to_sparse_csr()
        dense = a.to_dense()

        def call():
            return torch.sparse.sampled_addmm(a, dense, dense, beta=0.0)

        total = int(round(call().values().double().sum().item()))
        if total != 6 * want_total:
            return None, f"sum {total} != 6 x {want_total}"
        ms = cuda_ms(call, 5)
        del dense
        return ms, None
    except (RuntimeError, NotImplementedError) as e:  # a yardstick, on no path
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"


def parent_csr_call(lib):
    """8ff7365's csr_triangles.cu over ``lib``, driven as its wrapper drove
    it: two (row, col) entries a slot, the repo's radix sort of
    ``neighborhoods.cu`` (one sort of a fused row << cb | col key where it
    fits 31 bits, else by column, the prefix mask, and stably by row), then
    the bounds, binary-search and finish kernels.  call(u, v, ok, n_v) ->
    int64 [K]; call.scratch_bytes(k, e, n_v) its device bytes beyond inputs
    and output."""
    import torch
    from gelly_streaming_tpu_torch.ops import _cuda

    nb = _cuda.library("neighborhoods.cu")

    def shape(k, e, n_v):
        cb = (n_v - 1).bit_length()
        return 2 * k * e, cb if (k * n_v - 1).bit_length() + cb <= 31 else 0

    def scratch_bytes(k, e, n_v):
        n, _ = shape(k, e, n_v)
        return int(lib.csr_scratch_bytes(k, e, n_v)) + 9 * n + 12 + int(nb.nb_scratch_bytes(n, 0))

    def call(u, v, ok, n_v):
        k, e = u.shape
        dev = u.device
        n, shift = shape(k, e, n_v)
        out = torch.zeros((k,), dtype=torch.int64, device=dev)
        rows = torch.empty((n,), dtype=torch.int32, device=dev)
        cols = torch.empty((n,), dtype=torch.int32, device=dev)
        mask = torch.empty((n,), dtype=torch.bool, device=dev)
        meta = torch.empty((3,), dtype=torch.int32, device=dev)
        sort_scratch = torch.empty((nb.nb_scratch_bytes(n, 0),), dtype=torch.uint8, device=dev)
        scratch = torch.empty((lib.csr_scratch_bytes(k, e, n_v),), dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ss = (sort_scratch.data_ptr(), sort_scratch.numel())

        def sort(src, dst):
            _cuda.check(nb.nb_sort_launch(src.data_ptr(), dst.data_ptr(), mask.data_ptr(), n, 0, *ss, stream),
                        "parent nb_sort_launch")
            _cuda.check(nb.nb_sorted_launch(n, 0, *ss, src.data_ptr(), dst.data_ptr(), None, meta.data_ptr(),
                                            stream), "parent nb_sorted_launch")

        _cuda.check(lib.csr_expand_launch(u.data_ptr(), v.data_ptr(), ok.data_ptr(), k, e, n_v, shift,
                                          rows.data_ptr(), cols.data_ptr(), mask.data_ptr(), stream), "parent expand")
        if shift:
            sort(rows, cols)
        else:
            sort(cols, rows)
            _cuda.check(lib.csr_prefix_mask_launch(meta.data_ptr(), n, mask.data_ptr(), stream), "parent prefix mask")
            sort(rows, cols)
        _cuda.check(lib.csr_count_launch(u.data_ptr(), v.data_ptr(), ok.data_ptr(), k, e, n_v, shift,
                                         rows.data_ptr(), cols.data_ptr(), meta.data_ptr(), out.data_ptr(),
                                         scratch.data_ptr(), scratch.numel(), stream), "parent count")
        return out

    call.scratch_bytes = scratch_bytes
    return call


def csr_lookups(u, v, ok, n_v: int) -> int:
    """The lookups the kernel's inputs need: the sum over valid slots of
    min(d_u, d_v), d a row's length in its pane (both directions)."""
    u, v, ok = (t.cpu().numpy() for t in (u, v, ok))
    total = 0
    for p in range(u.shape[0]):
        a, b = u[p], v[p]
        live = ok[p] & (a >= 0) & (a < n_v) & (b >= 0) & (b < n_v)
        a, b = a[live].astype(np.int64), b[live].astype(np.int64)
        deg = np.bincount(np.concatenate([a, b]), minlength=n_v)
        total += int(np.minimum(deg[a], deg[b]).sum())
    return total


def csr_split(fn) -> dict:
    """torch.profiler's device ms a call of each kernel and memset ``fn``
    runs, over the calls the trace holds (up to 3), or {} where the
    profiler fails."""
    try:
        rows = profiler_device_us(fn, 3)
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")
        return {}
    rows = {k: v for k, v in rows.items() if not k.startswith(("aten::", "Activity Buffer"))}
    if not rows:
        return {}
    # the calls the trace holds: every kernel and memset here runs at least once a call
    calls = min(n for _, n in rows.values())
    split = {}
    for key, (us, n) in rows.items():
        short = re.split(r"[<(]", key.replace("(anonymous namespace)::", "").removeprefix("void "))[0].strip()
        split[short] = round(split.get(short, 0.0) + us * n / calls / 1e3, 5)
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def csr_shape(dev, cpm, name: str, u, v, ok, n_v: int, d: int, twin: bool, parent=None) -> dict:
    """csr_triangles at one shape: device-only ms on a held stream, the host
    enqueue, back-to-back events, the bytes bound, the design figure (the
    lookups, their rate, the entry bytes), its scratch and its split by
    kernel; with ``twin`` the plain twin's time and its equality; with
    ``parent`` (a ``parent_csr_call``) that version's counts, scratch and
    split, and its device ms in turns with the current (parent, current,
    current, parent)."""
    import torch
    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import csr_triangles as ct

    k, e = u.shape
    got = ct.csr_triangles(u, v, ok, n_v, d)
    err = 0
    plain_ms = None
    if twin:
        want = ct.csr_triangles_plain(u, v, ok, n_v, d)
        err = int((got - want).abs().max())
        plain_ms = cuda_ms(lambda: ct.csr_triangles_plain(u, v, ok, n_v, d), 1, warmup=0)
        if err:
            raise RuntimeError(f"csr_triangles {name}: kernel {got.tolist()} != twin {want.tolist()}")
    scratch = ct.scratch_bytes(k, e, n_v)
    if scratch != _cuda.library("csr_triangles.cu").csr_scratch_bytes(k, e, n_v):
        raise RuntimeError(f"csr_triangles {name}: plan's scratch {scratch} != csr_scratch_bytes")
    d_ms, h_us = device_ms(lambda: ct.csr_triangles(u, v, ok, n_v, d), CSR_REPS[name], cpm)
    e_valid = int(ok.sum())
    lookups = csr_lookups(u, v, ok, n_v)
    bound_ms = (9 * k * e + 8 * k) / HBM_BYTES_PER_S * 1e3  # u, v, ok read once, K int64 counts written
    r = {"k": k, "e_pad": e, "n_v": n_v, "d": d, "edges": e_valid, "counts": got.tolist(),
         "device_ms": d_ms, "host_us": h_us, "ms": cuda_ms(lambda: ct.csr_triangles(u, v, ok, n_v, d), 5),
         "bound_ms": bound_ms, "scratch_bytes": scratch, "plain_ms": plain_ms, "err": err,
         "lookups": lookups, "lookups_per_s": lookups / (d_ms * 1e-3),
         # two 4-byte entries a valid edge written; each row read once for its lookup, one entry a lookup
         "entry_bytes_written": 8 * e_valid, "entry_bytes_read_at_least": 4 * (2 * e_valid + lookups)}
    if parent is not None:
        prev = parent(u, v, ok, n_v)
        if not torch.equal(prev, got):
            raise RuntimeError(f"csr_triangles {name}: parent version {prev.tolist()} != {got.tolist()}")
        calls = {"parent": lambda: parent(u, v, ok, n_v), "current": lambda: ct.csr_triangles(u, v, ok, n_v, d)}
        r["turns"] = [(w, device_ms(calls[w], CSR_REPS[name], cpm)[0]) for w in ("parent", "current", "current",
                                                                                 "parent")]
        r["parent_scratch_bytes"] = parent.scratch_bytes(k, e, n_v)
        r["parent_split_ms"] = csr_split(calls["parent"])
        log(f"  csr_triangles {name}, device ms in turns with the parent (8ff7365): {r['turns']}; parent scratch "
            f"{r['parent_scratch_bytes']} B; parent by kernel (torch.profiler, ms a call): {r['parent_split_ms']}")
    r["split_ms"] = csr_split(lambda: ct.csr_triangles(u, v, ok, n_v, d))
    log(f"  csr_triangles {name} by kernel (torch.profiler, ms a call): {r['split_ms']}")
    log(f"  csr_triangles {name} (K={k}, E_pad={e}, {e_valid} edges, n_v={n_v}, D={d}): device {d_ms:.5f} ms "
        f"({d_ms / bound_ms:.1f}x its bound {bound_ms:.6f} ms, bytes), host enqueue {h_us:.2f} us, back-to-back "
        f"{r['ms']:.5f} ms, scratch {scratch} B, plain twin {'-' if plain_ms is None else f'{plain_ms:.3f} ms'}; "
        f"design figure (not the bound): {lookups} lookups (sum of min(d_u, d_v)), {r['lookups_per_s']:.6g} "
        f"lookups/s, entry bytes written {r['entry_bytes_written']}, read >= {r['entry_bytes_read_at_least']}; "
        f"counts {got.tolist()}")
    torch.cuda.synchronize()
    return r


def phase_async(dev, cpm, tri_stream, host_panes, expected, parent_csr=None) -> dict:
    """Phase 14: the async window pipeline and the superbatch planes on the
    card (module docstring), and csr_triangles (``parent_csr``: a
    ``parent_csr_call`` timed in turns with it in (d))."""
    import dataclasses

    import torch
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.core.types import EdgeDirection
    from gelly_streaming_tpu_torch.core.windows import group_panes
    from gelly_streaming_tpu_torch.io.prefetch import upload
    from gelly_streaming_tpu_torch.io.sources import _batched
    from gelly_streaming_tpu_torch.library import triangles as tri
    from gelly_streaming_tpu_torch.ops import csr_triangles as ct
    from gelly_streaming_tpu_torch.ops import dense_triangles as dt
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
    from gelly_streaming_tpu_torch.utils import metrics

    env_depth = os.environ.pop("GELLY_ASYNC_WINDOWS", None)  # both modes set by their configs
    res = {}
    log(f"  (a) the reference's windowed-CC bench shape: {ASYNC_WINDOWS} windows x {ASYNC_WIN_EDGES} edges over "
        f"{ASYNC_CAPACITY} vertices, batches of {ASYNC_WIN_EDGES // 2}, 100 ms windows, default_rng(3)")
    rng = np.random.default_rng(3)
    n = ASYNC_WINDOWS * ASYNC_WIN_EDGES
    src = rng.integers(0, ASYNC_CAPACITY, n).astype(np.int32)
    dst = rng.integers(0, ASYNC_CAPACITY, n).astype(np.int32)
    a = cc_planes(dev, "(a)", src, dst, ASYNC_WIN_EDGES, ASYNC_CAPACITY,
                  {"sync": {}, f"async {ASYNC_DEPTH}": {"async_windows": ASYNC_DEPTH}})
    (s_s, _, _), (a_s, a_stats, _) = a["sync"], a[f"async {ASYNC_DEPTH}"]
    log(f"  (a) sync {n / s_s:.6g} edges/s, async {n / a_s:.6g} edges/s, async/sync {s_s / a_s:.4f}; emissions "
        f"equal element for element: True; pipeline counters {a_stats}")
    res["bench"] = {"sync_eps": n / s_s, "async_eps": n / a_s, "ratio": s_s / a_s, "stats": a_stats}

    log(f"  (b) the same query at the CC bench's width: {WIDE_WINDOWS} windows x {WIDE_WIN_EDGES} uniform edges over "
        f"{CC_VERTICES} vertices (default_rng(0); 50 batches cut to {WIDE_WINDOWS} windows for time)")
    rng = np.random.default_rng(0)
    n = WIDE_WINDOWS * WIDE_WIN_EDGES
    src = rng.integers(0, CC_VERTICES, n).astype(np.int32)
    dst = rng.integers(0, CC_VERTICES, n).astype(np.int32)
    planes = {"sync": {}, f"async {ASYNC_DEPTH}": {"async_windows": ASYNC_DEPTH}, f"superbatch {SB_K}":
              {"superbatch": SB_K}, f"superbatch {SB_K} + async {ASYNC_DEPTH}":
              {"superbatch": SB_K, "async_windows": ASYNC_DEPTH}}
    b = cc_planes(dev, "(b)", src, dst, WIDE_WIN_EDGES, CC_VERTICES, planes)
    t_ms = (np.arange(n) // WIDE_WIN_EDGES) * 100 + 50
    cfg = StreamConfig(vertex_capacity=CC_VERTICES, batch_size=WIDE_WIN_EDGES // 2, async_windows=ASYNC_DEPTH)
    walls = []  # each call's wall: the last is the profiled run's
    busy, top = train_profile(lambda: walls.append(cc_window_run(
        cc_window_stream(src, dst, t_ms, WIDE_WIN_EDGES // 2, cfg, dev))[0]), 1)
    wall = walls[-1]
    idle = None if busy is None else 100 * (1 - busy / (wall * 1e3))
    log(f"  (b) records equal across the four planes; torch.profiler over one async {ASYNC_DEPTH} run: device busy "
        f"{busy} ms (sum of its kernel and copy rows) against that run's own wall {wall * 1e3:.1f} ms: idle "
        f"{'-' if idle is None else f'{idle:.2f}'}%; top rows {top}")
    res["wide"] = {k: {"s": v[0], "windows_per_s": WIDE_WINDOWS / v[0], "edges_per_s": n / v[0], "stats": v[1]}
                   for k, v in b.items()}
    res["wide_idle_pct"] = idle
    del src, dst, t_ms

    log(f"  (c) window_triangles over phase 4's stream: async {ASYNC_DEPTH} and superbatch {SB_K}")
    for name, kw in ((f"async {ASYNC_DEPTH}", {"async_windows": ASYNC_DEPTH}), (f"superbatch {SB_K}",
                                                                                 {"superbatch": SB_K})):
        stream = EdgeStream.from_batches(tri_stream._source_factory, dataclasses.replace(tri_stream.cfg, **kw),
                                         device=dev)
        tri.window_triangles(stream, WINDOW_MS).collect()  # warm-up
        torch.cuda.synchronize()
        dt.reset_launches()
        ct.reset_launches()
        t0 = time.perf_counter()
        records = tri.window_triangles(stream, WINDOW_MS).collect()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {**dt.LAUNCHES, **ct.LAUNCHES}
        if records != expected:
            raise RuntimeError(f"(c) {name}: counts differ from the sync path's and the twins':\n {records}")
        need = ("csr_triangles",) if "superbatch" in name else ("pane_adjacency", "dense_triangles", "csr_triangles")
        if min(launches[k] for k in need) <= 0:
            raise RuntimeError(f"(c) {name}: a kernel of the plane was not launched: {launches}")
        log(f"  (c) {name}: {len(records)} windows equal to the sync path and plain_pane_count; "
            f"{len(records) / secs:.3f} panes/s ({secs * 1e3:.1f} ms); launches {launches}")
        res[f"tri_{name.split()[0]}"] = {"panes_per_s": len(records) / secs, "launches": launches}
    res["sb_launches"] = res["tri_superbatch"]["launches"]["csr_triangles"]
    # the kernel against its twin on every superbatch group of the run
    groups = []
    for group in group_panes(iter(host_panes), SB_K, keep_empty=True):
        prepped = [p for p in (tri._superpane_canonical((g.src, g.dst)) for g in group) if p is not None]
        arrays, (n_v, d) = tri._superpane_rows(prepped)
        groups.append((to_dev(arrays, dev), n_v, d))
    err = 0
    for i, ((u, v, ok), n_v, d) in enumerate(groups):
        got = ct.csr_triangles(u, v, ok, n_v, d)
        want = ct.csr_triangles_plain(u, v, ok, n_v, d)
        err = max(err, int((got - want).abs().max()))
        if err:
            raise RuntimeError(f"(c) group {i}: csr_triangles {got.tolist()} != twin {want.tolist()}")
    log(f"  (c) csr_triangles equal to its twin on all {len(groups)} superbatch groups (max |err| {err})")

    log("  (d) csr_triangles alone, device only on a held stream")
    (u, v, ok), n_v, d = groups[0]
    shapes = {"group": csr_shape(dev, cpm, "group", u, v, ok, n_v, d, True, parent_csr)}
    lib_ms, why = sampled_addmm_ms(dev, u, v, ok, n_v, sum(shapes["group"]["counts"]))
    log(f"  library call at the group: torch.sparse.sampled_addmm over the {u.shape[0]} panes' block-diagonal "
        f"adjacency ({u.shape[0] * n_v} rows): " + (f"{lib_ms:.4f} ms" if lib_ms is not None else f"none ({why})"))
    meta, (cu, cv) = tri._pane_prepare((host_panes[-1].src, host_panes[-1].dst), dev)
    if meta[0] != "csr":
        raise RuntimeError(f"phase 4's sparse window did not take the CSR path: {meta}")
    cu, cv = to_dev((cu[None], cv[None]), dev)
    ones = torch.ones(cu.shape, dtype=torch.bool, device=dev)
    d_csr = 1 << (meta[2] - 1).bit_length()
    shapes["csr_window"] = csr_shape(dev, cpm, "csr_window", cu, cv, ones, meta[1], d_csr, True, parent_csr)
    lib_csr, why_csr = sampled_addmm_ms(dev, cu, cv, ones, meta[1], shapes["csr_window"]["counts"][0])
    log("  library call at the CSR window: " + (f"{lib_csr:.4f} ms" if lib_csr is not None else f"none ({why_csr})"))
    # phase 12's hub pane through window_triangles' sync path
    s_all, d_all = sage_stream_arrays()
    hs, hd = s_all[SAGE_PANES * SAGE_PANE_EDGES:], d_all[SAGE_PANES * SAGE_PANE_EDGES:]
    hub_cfg = StreamConfig(vertex_capacity=SAGE_VERTICES, batch_size=1 << 20)
    hub_stream = EdgeStream.from_batches(_batched(hs, hd, None, np.zeros(len(hs), np.int64), None,
                                                  hub_cfg.batch_size, dev), hub_cfg, device=dev)
    ct.reset_launches()
    t0 = time.perf_counter()
    hub_rec = tri.window_triangles(hub_stream, WINDOW_MS).collect()
    hub_s = time.perf_counter() - t0
    hub_launches = ct.LAUNCHES["csr_triangles"]
    t0 = time.perf_counter()
    oracle = csr_oracle(hs, hd)
    log(f"  hub pane (a star of {SAGE_HUB} beside Zipf edges, {len(hs)} edges) through window_triangles' sync path: "
        f"{hub_rec} in {hub_s:.3f} s, csr_triangles launches {hub_launches}; scipy oracle {oracle} "
        f"({time.perf_counter() - t0:.2f} s)")
    if hub_rec != [(oracle, WINDOW_MS - 1)] or hub_launches != 1:
        raise RuntimeError(f"hub pane: {hub_rec} against the oracle's {oracle}, {hub_launches} launches")
    meta, (cu, cv) = tri._pane_prepare((hs, hd), dev)
    cu, cv = to_dev((cu[None], cv[None]), dev)
    shapes["hub"] = csr_shape(dev, cpm, "hub", cu, cv, torch.ones(cu.shape, dtype=torch.bool, device=dev),
                              meta[1], 1 << (meta[2] - 1).bit_length(), False, parent_csr)
    shapes["hub"]["oracle"] = oracle
    if shapes["hub"]["counts"] != [oracle]:
        raise RuntimeError(f"hub pane alone: csr_triangles {shapes['hub']['counts']} != the oracle's {oracle}")
    res["csr"] = {"shapes": shapes, "library_ms": lib_ms, "library_csr_window_ms": lib_csr, "err": err,
                  "hub_launches": hub_launches}

    log(f"  (e) the snapshot plane: reduce_on_edges over {SNAP_PANES} uniform panes of phase 12 "
        f"({SAGE_PANE_EDGES} edges over {SAGE_VERTICES} vertices, OUT), sync and async 2")
    ns = SNAP_PANES * SAGE_PANE_EDGES
    ss, sd = s_all[:ns], d_all[:ns]
    sv = np.random.default_rng(5).random(ns, dtype=np.float32)
    del s_all, d_all
    snap = {}
    for name, depth in (("sync", 0), ("async 2", 2)):
        cfg = StreamConfig(vertex_capacity=SAGE_VERTICES, batch_size=1 << 20, ingest_window_edges=SAGE_PANE_EDGES,
                           async_windows=depth)
        stream = EdgeStream.from_batches(_batched(ss, sd, sv, None, None, cfg.batch_size, dev), cfg, device=dev)
        metrics.reset_pipeline_stats()
        nbh.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = stream.slice(WINDOW_MS, EdgeDirection.OUT).reduce_on_edges(lambda x, y: x + y).collect()
        secs = time.perf_counter() - t0
        snap[name] = (recs, secs, metrics.pipeline_stats(), nbh.LAUNCHES["build_buckets"])
        if snap[name][3] <= 0:
            raise RuntimeError(f"(e) {name}: build_buckets was not launched")
    if snap["sync"][0] != snap["async 2"][0]:
        raise RuntimeError("(e) the async snapshot plane's records differ from the sync path's")
    st = snap["async 2"][2]
    log(f"  (e) {len(snap['sync'][0])} records equal; sync {snap['sync'][1]:.3f} s, async 2 {snap['async 2'][1]:.3f} s; "
        f"build_buckets launches {snap['async 2'][3]}; dispatch stall {st['pipeline_dispatch_stall_s']} s, of it "
        f"build_buckets' calls (their host read of the bucket counts) {st['pipeline_dispatch_build_s']} s; drain "
        f"stall {st['pipeline_drain_stall_s']} s")
    res["snapshot"] = {"sync_s": snap["sync"][1], "async_s": snap["async 2"][1], "stats": st}
    if env_depth is not None:
        os.environ["GELLY_ASYNC_WINDOWS"] = env_depth
    return res


# ---------------------------------------------------------------------------
# phase 15: the streaming ExactTriangleCount

ET_VERTICES = 1 << 20  # (a): the CC bench's width (bench.py:2190-2192)
ET_RING_K, ET_REWIRE = 16, 0.1  # Watts-Strogatz ring degree and rewiring probability
ET_DEGREE = 64
ET_BATCH = 1 << 16
ET_TWIN_BATCHES = 4  # (a): the first batches' blocks held against the twin
ET_RMAT_SCALE, ET_RMAT_EDGE_FACTOR = 18, 16  # (b): Graph500's Kronecker generator
ET_RMAT_ABC = (0.57, 0.19, 0.19)
ET_RMAT_TWIN_EDGES = 1 << 20  # (b): the prefix held against the twin batch by batch (cut for the twin's time)
ET_TRACE_EDGES, ET_TRACE_BATCH = 1 << 16, 1 << 12  # (c)
ET_REPS = 3  # held-stream calls, each on its own copy of the state (264 MB at (a))


def watts_strogatz(n: int, k: int, p: float, rng):
    """A Watts-Strogatz small world (Watts & Strogatz, Nature 1998): the
    ring lattice joining each vertex to its k/2 successors, each edge's far
    end rewired with probability p to a uniform vertex other than its
    near end, then the n k / 2 edges shuffled.  Rewiring may repeat an
    edge; the count ignores repeats."""
    near = np.repeat(np.arange(n, dtype=np.int64), k // 2)
    far = (near + np.tile(np.arange(1, k // 2 + 1), n)) % n
    rewire = rng.random(len(near)) < p
    w = rng.integers(0, n - 1, int(rewire.sum()))
    far[rewire] = w + (w >= near[rewire])
    order = rng.permutation(len(near))
    return near[order].astype(np.int32), far[order].astype(np.int32)


def rmat_edges(scale: int, edge_factor: int, abc, rng):
    """Graph500's Kronecker (R-MAT) generator: each of the edge_factor
    2^scale edges picks a quadrant per bit with probabilities A, B, C and
    1 - A - B - C, then the vertex labels are permuted and the edges
    shuffled.  Duplicates and self-loops stay."""
    a, b, c = abc
    m = edge_factor << scale
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        src |= (r >= a + b).astype(np.int64) << bit
        dst |= (((r >= a) & (r < a + b)) | (r >= a + b + c)).astype(np.int64) << bit
    perm = rng.permutation(1 << scale)
    order = rng.permutation(m)
    return perm[src[order]].astype(np.int32), perm[dst[order]].astype(np.int32)


def triangle_oracle(src, dst, n: int):
    """(per-vertex triangles int64 [n], total) of the simple undirected
    graph of the edges, by scipy: row sums of (A @ A) * A over 2, the
    total over 6."""
    from scipy.sparse import coo_matrix

    keep = src != dst
    a = coo_matrix((np.ones(int(keep.sum()), np.int64), (src[keep], dst[keep])), shape=(n, n)).tocsr()
    a = a + a.T
    a.data[:] = 1
    t = (a @ a).multiply(a)
    local = np.asarray(t.sum(axis=1)).ravel() // 2
    return local, int(local.sum()) // 3


def host_diff_block(state, prev_local: np.ndarray, src, dst, mask):
    """The JAX package's block emission (its library/triangles.py:686-707):
    the whole local vector read back and diffed on the host; returns
    (keys, counts, local on the host)."""
    local_h = state.local.cpu().numpy()
    m_h = mask.cpu().numpy()
    touched = np.unique(np.concatenate([src.cpu().numpy()[m_h], dst.cpu().numpy()[m_h],
                                        np.nonzero(local_h != prev_local)[0]]))
    keys = np.concatenate([touched, [-1]]).astype(np.int64)
    counts = np.concatenate([local_h[touched], [int(state.global_count)]])
    return keys, counts, local_h


def fold_bytes(before, after, src, dst, mask) -> int:
    """The fold's least bytes (the bound): the batch's edges read once (9 B
    an edge); each distinct row an edge that is not masked or a self-loop
    reads (either endpoint) once, its valid part as the batch found it and
    its degree; and 4 B for each new slot, moved degree and moved counter,
    and the global."""
    import torch
    from gelly_streaming_tpu_torch.ops import indexing

    c = before.local.shape[0]
    lo, hi = torch.minimum(src, dst), torch.maximum(src, dst)
    valid = mask & (lo != hi)
    rows = torch.unique(indexing.gather_index(torch.cat([lo[valid], hi[valid]]), c))
    slots = int(before.table.deg.to(torch.int64)[rows].clamp(0, before.table.nbrs.shape[1]).sum())
    new_slots = int(after.table.deg.sum(dtype=torch.int64) - before.table.deg.sum(dtype=torch.int64))
    moved = int((after.table.deg != before.table.deg).sum()) + int((after.local != before.local).sum())
    return 9 * src.shape[0] + 4 * slots + 4 * rows.numel() + 4 * (new_slots + moved) + 4


def state_diff(a, b) -> int:
    """The largest absolute difference over two states' five tensors."""
    import torch

    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) if x.numel() else 0
               for x, y in zip((*a.table, a.local, a.global_count), (*b.table, b.local, b.global_count)))


def block_diff(a, b) -> int:
    """0 when two record blocks are equal in length, values and dtypes."""
    if len(a.columns) != len(b.columns) or any(x.dtype != y.dtype or x.shape != y.shape
                                               for x, y in zip(a.columns, b.columns)):
        return 1 << 62
    return max(int(np.abs(x.astype(np.int64) - y.astype(np.int64)).max()) if len(x) else 0
               for x, y in zip(a.columns, b.columns))


def edge_batch(batch):
    from gelly_streaming_tpu_torch.core.types import EdgeBatch

    return EdgeBatch(src=batch[0], dst=batch[1], mask=batch[2])


def exact_run(stream, mode: str, keep: int):
    """(seconds first batch -> last record on the host, records, the first
    ``keep`` blocks (block mode) or every record (trace), the runner)."""
    import torch
    from gelly_streaming_tpu_torch.library.triangles import ExactTriangleCount

    runner = ExactTriangleCount(mode=mode)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mode == "block":
        kept, n_records = [], 0
        for i, blk in enumerate(runner.run(stream).blocks()):
            n_records += blk.num_records
            if i < keep:
                kept.append(blk)
    else:
        kept = runner.run(stream).collect()
        n_records = len(kept)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, n_records, kept, runner


def fold_timing(cpm, fold, before, batch) -> dict:
    """The fold of one batch from ``before``, each call on its own copy of
    the state: device ms on a held stream, host enqueue us, back-to-back
    events ms; and the bytes bound of that batch."""
    import torch
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    s, d, m = batch
    d_ms, h_us = copies_device_ms(lambda cp: fold(cp, s, d, m), lambda: et.clone_state(before), ET_REPS, cpm)
    copies = [et.clone_state(before) for _ in range(ET_REPS)]
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for cp in copies:
        fold(cp, s, d, m)
    end.record()
    torch.cuda.synchronize()
    after = copies[0]
    bound = fold_bytes(before, after, s, d, m) / HBM_BYTES_PER_S * 1e3
    del copies
    return {"device_ms": d_ms, "host_us": h_us, "ms": start.elapsed_time(end) / ET_REPS, "bound_ms": bound}


def exact_scratch(n: int, capacity: int, max_degree: int, r: int, trace: bool) -> int:
    """The bytes of the scratch buffer the wrapper holds for that call shape
    (the one its timed calls used), checked against the C library's size."""
    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    held = {key[2:]: buf.numel() for key, buf in et._scratch.items()}
    want = int(_cuda.library("exact_triangles.cu").exact_scratch_bytes(n, capacity, max_degree, r, int(trace)))
    if held.get((n, capacity, max_degree, r, trace)) != want:
        raise RuntimeError(f"exact fold scratch for {(n, capacity, max_degree, r, trace)}: held {held}, the C "
                           f"library's {want} B")
    return want


EXACT_KERNELS = ("prep_kernel", "chain_kernel", "settle_kernel", "count_kernel", "trace_scan_kernel")


def exact_split(fold, before, batch, reps: int = 5) -> dict:
    """torch.profiler's device us of each launch of one fold call (each call
    on its own copy of the state): {kernel or "memsets": us a call}."""
    import torch
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    copies = iter([et.clone_state(before) for _ in range(reps + 1)])
    rows = profiler_device_us(lambda: fold(next(copies), *batch), reps)
    split = {}
    for key, (us, calls) in rows.items():
        for name in EXACT_KERNELS:
            if re.search(rf"\b{name}\b", key):
                split[name] = split.get(name, 0.0) + us * calls / reps
        if "memset" in key.lower():
            split["memsets"] = split.get("memsets", 0.0) + us * calls / reps
    del copies
    torch.cuda.empty_cache()
    return {k: round(v, 3) for k, v in split.items()}


def parent_exact_calls(lib):
    """(block, trace): 5e8e61b's two folds over ``lib``, called as its
    wrappers called them (one launch, one thread block walking the chunks)."""
    import torch
    from gelly_streaming_tpu_torch.ops import _cuda

    def args(state, s, d, m):
        nbrs, deg, dropped = state.table
        return (nbrs.data_ptr(), deg.data_ptr(), dropped.data_ptr(), state.local.data_ptr(),
                state.global_count.data_ptr(), s.data_ptr(), d.data_ptr(), m.data_ptr(), s.shape[0], *nbrs.shape)

    def block(state, s, d, m):
        _cuda.check(lib.triangle_block_launch(*args(state, s, d, m), min(64, s.shape[0]),
                                              torch.cuda.current_stream(s.device).cuda_stream), "parent triangle_block")
        return state

    def trace(state, s, d, m):
        lt = torch.empty((s.shape[0], 2), dtype=torch.int32, device=s.device)
        gt = torch.empty((s.shape[0],), dtype=torch.int32, device=s.device)
        _cuda.check(lib.triangle_trace_launch(*args(state, s, d, m), lt.data_ptr(), gt.data_ptr(),
                                              torch.cuda.current_stream(s.device).cuda_stream), "parent triangle_trace")
        return state, lt, gt

    return block, trace


def exact_turns(cpm, label: str, old, new, before, batch) -> dict:
    """The parent's and the current fold of one batch from ``before`` in
    turns (parent, current, current, parent), each call on its own copy:
    device ms held and host enqueue us; and whether the two give the same
    state (and traces)."""
    import torch
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    got = []
    for tag, fn in (("parent", old), ("current", new), ("current", new), ("parent", old)):
        ms, us = copies_device_ms(lambda cp: fn(cp, *batch), lambda: et.clone_state(before), ET_REPS, cpm)
        got.append((tag, ms, us))
    a, b = old(et.clone_state(before), *batch), new(et.clone_state(before), *batch)
    if not isinstance(a, et.TriangleCountState):  # a trace fold: (state, local trace, global trace)
        diff = max(state_diff(a[0], b[0]), int(not torch.equal(a[1], b[1])), int(not torch.equal(a[2], b[2])))
    else:
        diff = state_diff(a, b)
    if diff:
        raise RuntimeError(f"{label}: the parent's fold and the current one differ by {diff}")
    p_ms, c_ms = (got[0][1] + got[3][1]) / 2, (got[1][1] + got[2][1]) / 2
    log(f"  {label} in turns: " + "; ".join(f"{tag} {ms:.4f} ms (host {us:.1f} us)" for tag, ms, us in got)
        + f"; parent {p_ms:.4f} ms, current {c_ms:.4f} ms, {p_ms / c_ms:.2f}x; equal states")
    torch.cuda.empty_cache()
    return {"parent_ms": p_ms, "current_ms": c_ms, "ratio": p_ms / c_ms, "turns": [ms for _, ms, _ in got],
            "host_us": [us for _, _, us in got]}


def exact_paths(label: str, dev, batches: int) -> dict:
    """The fold's device counters since the last reset: every batch of the
    run on the parallel path, none on the chain kernel."""
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    got = et.stats(dev)
    if got["parallel"] != batches or got["chain"]:
        raise RuntimeError(f"{label}: {batches} batches, paths {got}")
    got["passes_a_batch"] = got["passes"] / batches
    return got


def exact_profile(fn, require=()):
    """(device busy ms, wall ms, top rows) of one run of ``fn`` under
    torch.profiler, with no warm-up run (the counted run warmed it); busy
    None if the profile holds no row of a kernel in ``require``."""
    walls = []

    def timed():
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)

    busy, top = train_profile(timed, 1, warmup=False, require=require)
    return busy, walls[-1] * 1e3, top


def phase_exact(dev, cpm, parent=None) -> dict:
    """Phase 15: ExactTriangleCount on the card, block mode at the CC
    bench's width (a), on a skewed stream whose hub rows overflow (b), and
    trace mode (c); every batch on the parallel path.  ``parent``: (block,
    trace) folds of an earlier build, timed in turns with the current."""
    import torch
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.output import RecordBlock
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library import triangles as tri
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    res, err = {}, 0
    t_phase = time.perf_counter()
    # (a) ------------------------------------------------------------------
    src, dst = watts_strogatz(ET_VERTICES, ET_RING_K, ET_REWIRE, np.random.default_rng(5))
    n = len(src)
    log(f"  (a) Watts-Strogatz n = {ET_VERTICES}, k = {ET_RING_K}, p = {ET_REWIRE}: {n} edges shuffled by "
        f"default_rng(5); C = {ET_VERTICES}, D = {ET_DEGREE}, batches of {ET_BATCH}")
    cfg = StreamConfig(vertex_capacity=ET_VERTICES, max_degree=ET_DEGREE, batch_size=ET_BATCH)
    stream = EdgeStream.from_arrays(src, dst, cfg, device=dev)
    # warm the path (the kernel, the emission's unique and nonzero) outside the counted run
    exact_run(EdgeStream.from_arrays(src[:8192], dst[:8192], cfg, batch_size=4096, device=dev), "block", 0)
    et.reset_launches()
    et.reset_stats()
    secs, n_records, kept, runner = exact_run(stream, "block", ET_TWIN_BATCHES)
    launches = dict(et.LAUNCHES)
    twin_calls = dict(et.TWIN_CALLS)
    paths = exact_paths("(a)", dev, launches["triangle_block"])
    state = runner.final_state
    dropped, glob = int(state.table.dropped), int(state.global_count)
    if launches["triangle_block"] != -(-n // ET_BATCH) or any(twin_calls.values()):
        raise RuntimeError(f"(a): launches {launches}, twin calls {twin_calls}")
    if dropped:
        raise RuntimeError(f"(a): {dropped} rows dropped at D = {ET_DEGREE}")
    t0 = time.perf_counter()
    want_local, want_total = triangle_oracle(src, dst, ET_VERTICES)
    oracle_s = time.perf_counter() - t0
    local_err = int(np.abs(state.local.cpu().numpy().astype(np.int64) - want_local).max())
    if local_err or glob != want_total:
        raise RuntimeError(f"(a): local differs from scipy by {local_err}; global {glob} against {want_total}")
    log(f"  (a) {secs:.4f} s first batch -> last block: {n / secs:.6g} edges/s, {n_records} records, "
        f"{n_records / secs:.6g} records/s; launches {launches}, twin calls through the wrappers {twin_calls}; "
        f"dropped == 0; global {glob} and every local count equal to scipy's (A @ A) * A ({oracle_s:.1f} s); "
        f"paths {paths} (every batch parallel)")
    # the first batches through the twin on the card, block by block
    batches = [(torch.from_numpy(src[i:i + ET_BATCH]).to(dev), torch.from_numpy(dst[i:i + ET_BATCH]).to(dev),
                torch.ones(ET_BATCH, dtype=torch.bool, device=dev))
               for i in range(0, (ET_TWIN_BATCHES + 1) * ET_BATCH, ET_BATCH)]
    twin = tri.init_triangle_state(cfg, dev)
    prev = twin.local.clone()
    plain_s = []
    for i in range(ET_TWIN_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt = et.triangle_update_block_plain(twin, *batches[i])
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t0)
        blk = tri.touched_block(nxt, prev, edge_batch(batches[i]))
        err = max(err, block_diff(blk, kept[i]))
        prev, twin = nxt.local.clone(), nxt
    if err:
        raise RuntimeError(f"(a): the first {ET_TWIN_BATCHES} blocks differ from the twin's by {err}")
    res["plain_ms"] = float(np.mean(plain_s)) * 1e3
    log(f"  (a) the first {ET_TWIN_BATCHES} batches' blocks equal the twin's on the card (the twin "
        f"{res['plain_ms']:.1f} ms a batch, its chunk steps replayed from a CUDA graph)")
    timing = fold_timing(cpm, et.triangle_update_block, twin, batches[ET_TWIN_BATCHES])
    timing["split_us"] = exact_split(et.triangle_update_block, twin, batches[ET_TWIN_BATCHES])
    timing["scratch_bytes"] = exact_scratch(ET_BATCH, ET_VERTICES, ET_DEGREE, 64, False)
    after = et.triangle_update_block(et.clone_state(twin), *batches[ET_TWIN_BATCHES])
    # a late batch: the kernel's own state before the run's last batch, held against the twin
    n_full = n // ET_BATCH
    late = tri.init_triangle_state(cfg, dev)

    def dev_batch(i):
        return (torch.from_numpy(src[i * ET_BATCH:(i + 1) * ET_BATCH]).to(dev),
                torch.from_numpy(dst[i * ET_BATCH:(i + 1) * ET_BATCH]).to(dev),
                torch.ones(ET_BATCH, dtype=torch.bool, device=dev))

    for i in range(n_full - 1):
        et.triangle_update_block(late, *dev_batch(i))
    late_batch = dev_batch(n_full - 1)
    lerr = state_diff(et.triangle_update_block(et.clone_state(late), *late_batch),
                      et.triangle_update_block_plain(late, *late_batch))
    if lerr:
        raise RuntimeError(f"(a): batch {n_full - 1} differs from the twin's by {lerr}")
    timing_late = fold_timing(cpm, et.triangle_update_block, late, late_batch)
    timing_late["split_us"] = exact_split(et.triangle_update_block, late, late_batch)
    timing_late["batch"] = n_full - 1
    turns = {}
    if parent:
        turns["a_batch4"] = exact_turns(cpm, f"(a) batch {ET_TWIN_BATCHES}", parent[0], et.triangle_update_block,
                                        twin, batches[ET_TWIN_BATCHES])
        turns["a_late"] = exact_turns(cpm, f"(a) batch {n_full - 1}", parent[0], et.triangle_update_block, late,
                                      late_batch)
    del late, late_batch
    # emission: the port's (touched set on the card) against the JAX package's host diff
    prev_h = twin.local.cpu().numpy()
    emit_us, host_us = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blk = tri.touched_block(after, twin.local, edge_batch(batches[ET_TWIN_BATCHES]))
        emit_us.append((time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        keys, counts, _ = host_diff_block(after, prev_h, *batches[ET_TWIN_BATCHES])
        host_us.append((time.perf_counter() - t0) * 1e6)
        if block_diff(blk, RecordBlock((keys, counts))):
            raise RuntimeError("(a): the card's touched block differs from the host diff's")
    res["emit_us"], res["host_diff_us"] = float(np.median(emit_us)), float(np.median(host_us))
    busy, wall_ms, top = exact_profile(lambda: exact_run(stream, "block", 0))
    idle = None if busy is None else 100 * (1 - busy / wall_ms)
    log(f"  (a) the fold of batch {ET_TWIN_BATCHES} ({ET_BATCH} edges, scratch {timing['scratch_bytes']} B): device "
        f"{timing['device_ms']:.4f} ms held, back-to-back {timing['ms']:.4f} ms, host enqueue "
        f"{timing['host_us']:.2f} us; bound {timing['bound_ms']:.6f} ms (bytes), "
        f"{timing['device_ms'] / timing['bound_ms']:.1f}x; by launch (profiler, us) {timing['split_us']}; batch "
        f"{timing_late['batch']} (equal to the twin): device {timing_late['device_ms']:.4f} ms held, host "
        f"{timing_late['host_us']:.2f} us, bound {timing_late['bound_ms']:.6f} ms, by launch {timing_late['split_us']}; "
        f"fixed-point passes {paths['passes_a_batch']:.3f} a batch (most {paths['max_passes']}); "
        f"emission a batch: the card's touched set "
        f"{res['emit_us']:.1f} us, the JAX package's host diff {res['host_diff_us']:.1f} us (equal blocks); "
        f"torch.profiler over one run: device busy {busy} ms of {wall_ms:.1f} ms, idle "
        f"{'-' if idle is None else f'{idle:.2f}'}%; top rows {top}")
    res["a"] = {"edges": n, "s": secs, "edges_per_s": n / secs, "records": n_records,
                "records_per_s": n_records / secs, "global": glob, "dropped": dropped, "launches": launches,
                "oracle_s": oracle_s, "idle_pct": idle, "busy_ms": busy, "profiled_wall_ms": wall_ms, "top": top,
                "paths": paths, "late": timing_late, **turns, **timing}
    res["launches"] = launches["triangle_block"]
    del stream, runner, state, twin, after, batches
    torch.cuda.empty_cache()

    # (b) ------------------------------------------------------------------
    c_b = 1 << ET_RMAT_SCALE
    rsrc, rdst = rmat_edges(ET_RMAT_SCALE, ET_RMAT_EDGE_FACTOR, ET_RMAT_ABC, np.random.default_rng(6))
    nb = len(rsrc)
    log(f"  (b) Graph500 Kronecker scale {ET_RMAT_SCALE}, edge factor {ET_RMAT_EDGE_FACTOR}, "
        f"A, B, C = {ET_RMAT_ABC}: {nb} edges (default_rng(6)), {int((rsrc == rdst).sum())} self-loops; "
        f"C = {c_b}, D = {ET_DEGREE}")
    cfg_b = StreamConfig(vertex_capacity=c_b, max_degree=ET_DEGREE, batch_size=ET_BATCH)
    stream_b = EdgeStream.from_arrays(rsrc, rdst, cfg_b, device=dev)
    twin_batches = ET_RMAT_TWIN_EDGES // ET_BATCH
    et.reset_launches()
    et.reset_stats()
    secs_b, rec_b, kept_b, runner_b = exact_run(stream_b, "block", twin_batches)
    launches_b = dict(et.LAUNCHES)
    if launches_b["triangle_block"] != -(-nb // ET_BATCH) or any(et.TWIN_CALLS.values()):
        raise RuntimeError(f"(b): launches {launches_b}, twin calls {et.TWIN_CALLS}")
    paths_b = exact_paths("(b)", dev, launches_b["triangle_block"])
    dropped_b = int(runner_b.final_state.table.dropped)
    if dropped_b <= 0:
        raise RuntimeError("(b): no row overflowed")
    kern = tri.init_triangle_state(cfg_b, dev)
    twin = tri.init_triangle_state(cfg_b, dev)
    prev_k, prev_t = kern.local.clone(), twin.local.clone()
    berr, before_last, emit_b = 0, None, []
    for i in range(twin_batches):
        batch = (torch.from_numpy(rsrc[i * ET_BATCH:(i + 1) * ET_BATCH]).to(dev),
                 torch.from_numpy(rdst[i * ET_BATCH:(i + 1) * ET_BATCH]).to(dev),
                 torch.ones(ET_BATCH, dtype=torch.bool, device=dev))
        if i == twin_batches - 1:
            before_last = (et.clone_state(kern), batch)
        twin = et.triangle_update_block_plain(twin, *batch)
        et.triangle_update_block(kern, *batch)
        berr = max(berr, state_diff(kern, twin))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bk = tri.touched_block(kern, prev_k, edge_batch(batch))
        emit_b.append((time.perf_counter() - t0) * 1e6)
        bt = tri.touched_block(twin, prev_t, edge_batch(batch))
        berr = max(berr, block_diff(bk, bt), block_diff(bk, kept_b[i]))
        prev_k.copy_(kern.local)
        prev_t.copy_(twin.local)
    if berr:
        raise RuntimeError(f"(b): the state or blocks differ from the twin's by {berr}")
    err = max(err, berr)
    timing_b = fold_timing(cpm, et.triangle_update_block, *before_last)
    timing_b["split_us"] = exact_split(et.triangle_update_block, *before_last)
    timing_b["scratch_bytes"] = exact_scratch(ET_BATCH, c_b, ET_DEGREE, 64, False)
    if parent:
        timing_b["turns"] = exact_turns(cpm, f"(b) batch {twin_batches - 1}", parent[0], et.triangle_update_block,
                                        *before_last)
    busy_b, wall_b, top_b = exact_profile(lambda: exact_run(stream_b, "block", 0))
    idle_b = None if busy_b is None else 100 * (1 - busy_b / wall_b)
    log(f"  (b) {secs_b:.4f} s: {nb / secs_b:.6g} edges/s, {rec_b} records, {rec_b / secs_b:.6g} records/s; "
        f"launches {launches_b}; dropped {dropped_b} > 0, global {int(runner_b.final_state.global_count)}; the "
        f"state (nbrs, deg, dropped, local, global) and the blocks equal the twin's on the card after each of the "
        f"first {twin_batches} batches ({twin_batches * ET_BATCH} edges; the rest not held for the twin's time); "
        f"batch {twin_batches - 1}: device {timing_b['device_ms']:.4f} ms held, host enqueue "
        f"{timing_b['host_us']:.2f} us, bound {timing_b['bound_ms']:.6f} ms, scratch {timing_b['scratch_bytes']} B, "
        f"by launch {timing_b['split_us']}; paths "
        f"{paths_b} ({paths_b['passes_a_batch']:.3f} passes a batch); emission a batch on the card "
        f"{np.median(emit_b):.1f} us; idle "
        f"{'-' if idle_b is None else f'{idle_b:.2f}'}% (busy {busy_b} ms of {wall_b:.1f} ms); top rows {top_b}")
    res["b"] = {"edges": nb, "s": secs_b, "edges_per_s": nb / secs_b, "records": rec_b,
                "records_per_s": rec_b / secs_b, "dropped": dropped_b, "launches": launches_b,
                "twin_edges": twin_batches * ET_BATCH, "idle_pct": idle_b, "busy_ms": busy_b, "paths": paths_b,
                "emit_us": float(np.median(emit_b)), **timing_b}
    del stream_b, runner_b, kern, twin, before_last
    torch.cuda.empty_cache()

    # (c) ------------------------------------------------------------------
    cfg_c = StreamConfig(vertex_capacity=ET_VERTICES, max_degree=ET_DEGREE, batch_size=ET_TRACE_BATCH)
    stream_c = EdgeStream.from_arrays(src[:ET_TRACE_EDGES], dst[:ET_TRACE_EDGES], cfg_c, device=dev)
    et.reset_launches()
    et.reset_stats()
    secs_c, rec_c, records, runner_c = exact_run(stream_c, "trace", 0)
    launches_c = dict(et.LAUNCHES)
    if launches_c["triangle_trace"] != ET_TRACE_EDGES // ET_TRACE_BATCH or any(et.TWIN_CALLS.values()):
        raise RuntimeError(f"(c): launches {launches_c}, twin calls {et.TWIN_CALLS}")
    paths_c = exact_paths("(c)", dev, launches_c["triangle_trace"])
    twin = tri.init_triangle_state(cfg_c, dev)
    want, plain_s, before_mid = [], 0.0, None
    for i in range(0, ET_TRACE_EDGES, ET_TRACE_BATCH):
        s = torch.from_numpy(src[i:i + ET_TRACE_BATCH]).to(dev)
        d = torch.from_numpy(dst[i:i + ET_TRACE_BATCH]).to(dev)
        m = torch.ones(ET_TRACE_BATCH, dtype=torch.bool, device=dev)
        if i == ET_TRACE_EDGES // 2:
            before_mid = (et.clone_state(twin), (s, d, m))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        twin, lt, gt = et.triangle_update_plain(twin, s, d, m)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        lt, gt = lt.cpu().numpy(), gt.cpu().numpy()
        for j, (u, v) in enumerate(zip(src[i:i + ET_TRACE_BATCH].tolist(), dst[i:i + ET_TRACE_BATCH].tolist())):
            want += [(min(u, v), int(lt[j, 0])), (max(u, v), int(lt[j, 1])), (-1, int(gt[j]))]
    cerr = state_diff(runner_c.final_state, twin)
    if records != want or cerr:
        raise RuntimeError(f"(c): the trace differs from the twin's (state diff {cerr})")
    timing_c = fold_timing(cpm, et.triangle_update, *before_mid)
    timing_c["split_us"] = exact_split(et.triangle_update, *before_mid)
    timing_c["scratch_bytes"] = exact_scratch(ET_TRACE_BATCH, ET_VERTICES, ET_DEGREE, 1, True)
    if parent:
        timing_c["turns"] = exact_turns(cpm, f"(c) batch {ET_TRACE_EDGES // 2 // ET_TRACE_BATCH}", parent[1],
                                        et.triangle_update, *before_mid)
    res["trace_plain_ms"] = plain_s / (ET_TRACE_EDGES // ET_TRACE_BATCH) * 1e3
    log(f"  (c) trace mode over the first {ET_TRACE_EDGES} edges of (a) in batches of {ET_TRACE_BATCH}: "
        f"{secs_c:.4f} s, {ET_TRACE_EDGES / secs_c:.6g} edges/s, {rec_c} records, {rec_c / secs_c:.6g} records/s; "
        f"launches {launches_c}; every record and the final state equal the twin's on the card "
        f"({res['trace_plain_ms']:.1f} ms a batch); the fold of batch {ET_TRACE_EDGES // 2 // ET_TRACE_BATCH}: "
        f"device {timing_c['device_ms']:.4f} ms held, host enqueue {timing_c['host_us']:.2f} us, bound "
        f"{timing_c['bound_ms']:.6f} ms, scratch {timing_c['scratch_bytes']} B, by launch {timing_c['split_us']}; "
        f"paths {paths_c}")
    res["c"] = {"edges": ET_TRACE_EDGES, "s": secs_c, "edges_per_s": ET_TRACE_EDGES / secs_c, "records": rec_c,
                "records_per_s": rec_c / secs_c, "launches": launches_c, "paths": paths_c, **timing_c}
    res["trace_launches"] = launches_c["triangle_trace"]
    res["err"] = err
    log(f"  phase 15: {time.perf_counter() - t_phase:.1f} s")
    return res


SP_SCALE, SP_EDGE_FACTOR, SP_SEED = 20, 16, 7  # (a)-(c): Graph500 scale 20, default_rng(7)
SP_WIN_EDGES = 1 << 22  # 4 tumbling windows of the 16,777,216 edges
SP_BATCH = 1 << 21
SP_ORACLE_SCALE = 14  # (c): the pane the numpy peeling oracle takes
SP_IC_BATCHES = 16  # (d): the CC bench's 50 batches cut to 16 for time
SP_BENCH_C, SP_BENCH_E, SP_BENCH_SEED = 1 << 15, 1 << 18, 17  # (e): bench.py:785-865
SP_REPS = 10  # held-stream calls (a fixpoint is one launch; a k-core sweep ~2 a bucket)
SP_SPLIT_ITERS = 10  # (b): the iterations RANK_SPLIT's builds are timed over


def sssp_oracle(src, dst, w, n: int, source: int) -> np.ndarray:
    """float64 distances from ``source`` by scipy's Dijkstra over the
    window's edges, the least weight of each repeated (src, dst) kept
    (scipy's sparse matrices would sum repeats); inf where unreached."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    key = src.astype(np.int64) * n + dst
    order = np.lexsort((w, key))
    first = np.ones(len(order), bool)
    first[1:] = key[order][1:] != key[order][:-1]
    sel = order[first]
    g = csr_matrix((w[sel].astype(np.float64), (src[sel], dst[sel])), shape=(n, n))
    return dijkstra(g, directed=True, indices=source)


def core_oracle(src, dst, n: int) -> np.ndarray:
    """Core numbers of the edges' simple undirected graph by Batagelj and
    Zaversnik's bucket peeling (arXiv cs/0310049), in plain Python."""
    a, b = np.minimum(src, dst).astype(np.int64), np.maximum(src, dst).astype(np.int64)
    keep = a != b
    key = np.unique(a[keep] * n + b[keep])
    s = np.concatenate([key // n, key % n])
    t = np.concatenate([key % n, key // n])
    order = np.argsort(s, kind="stable")
    nbr = t[order].tolist()
    deg_np = np.bincount(s, minlength=n)
    off = np.concatenate([[0], np.cumsum(deg_np)]).tolist()
    deg = deg_np.tolist()
    md = max(deg)
    bins = [0] * (md + 1)
    for d in deg:
        bins[d] += 1
    start = 0
    for d in range(md + 1):
        bins[d], start = start, start + bins[d]
    pos, vert = [0] * n, [0] * n
    for v in range(n):
        pos[v] = bins[deg[v]]
        vert[pos[v]] = v
        bins[deg[v]] += 1
    for d in range(md, 0, -1):
        bins[d] = bins[d - 1]
    bins[0] = 0
    for i in range(n):
        v = vert[i]
        for j in range(off[v], off[v + 1]):
            u = nbr[j]
            if deg[u] > deg[v]:
                du, pu = deg[u], pos[u]
                pw = bins[du]
                w = vert[pw]
                if u != w:
                    pos[u], pos[w] = pw, pu
                    vert[pu], vert[pw] = w, u
                bins[du] += 1
                deg[u] -= 1
    return np.asarray(deg, np.int64)


def sp_stream(src, dst, w, cfg, dev):
    """A valued stream over host arrays, batches of SP_BATCH uploaded to
    ``dev`` (the windowed path reads them back and cuts the panes)."""
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.core.types import EdgeBatch

    def factory():
        for i in range(0, len(src), SP_BATCH):
            yield EdgeBatch.from_arrays(src[i : i + SP_BATCH], dst[i : i + SP_BATCH], val=w[i : i + SP_BATCH],
                                        device=dev)

    return EdgeStream.from_batches(factory, cfg, device=dev)


def fixpoint_bytes(log, n: int, edges: int) -> int:
    """The bytes a fixpoint's iterations must move in the pane's layout,
    from the twin's log of (pull, frontier size, frontier edges): a pull
    reads src and weight of the dst-sorted copy (8 B an edge; the segments
    come from d_off), d_off and x and writes x and the frontier (13 B a
    vertex); a push reads the frontier's rows (8 B an edge) and their two
    offsets (8 B a frontier vertex), and reads and writes x and the
    frontier (10 B a vertex)."""
    return sum(8 * edges + 13 * n if pull else 8 * fe + 8 * f + 10 * n for pull, f, fe in log)


def pagerank_bytes(iters: int, n: int, edges: int) -> int:
    """An iteration reads d_src (4 B an edge), off, d_off and r and writes
    r_new (16 B a vertex); in_window is written once."""
    return iters * (4 * edges + 16 * n) + n


def kcore_sweep_bytes(buckets) -> int:
    """One round's bytes, each distinct byte of a bucket once: valid (1 B
    a slot), nbrs of the valid slots (4 B each), the distinct estimates
    read (4 B a distinct neighbour or key), the keys read and c written at
    them (8 B a row)."""
    import torch

    total = 0
    for b in buckets:
        live = b.nbrs[b.valid]
        total += b.valid.numel() + 4 * live.numel() + 8 * b.keys.numel()
        total += 4 * int(torch.unique(torch.cat([live, b.keys])).numel())
    return total


SP_SWEEP = (0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5)  # auto's thresholds, printed beside the default 0.05
SYNC_PROBE = 1000  # grid-wide syncs a probe call

# A cooperative launch of blocks of 256 threads that runs grid-wide syncs
# and nothing else: the cost of a sync at a fixpoint's block count.  Not a
# kernel of the port; this script writes it under the build directory.
GRID_SYNC_PROBE_CU = r"""#include <cooperative_groups.h>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) sync_probe_kernel(int syncs) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int i = 0; i < syncs; ++i) grid.sync();
}

extern "C" int grid_sync_probe_launch(int blocks, int syncs, void* stream) {
  void* args[] = {&syncs};
  const cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sync_probe_kernel),
                                                      dim3(static_cast<unsigned>(blocks)), dim3(256), args, 0,
                                                      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
"""
GRID_SYNC_SIGNATURES = {"grid_sync_probe_launch": [_I, _I, _P]}

# spmv.cu with the fixpoint's grid sized otherwise than a block a pull tile
# or a thread a vertex (phase 16 (e), in turns with the current): a thread
# a vertex, and a thread a vertex and an edge
_FIX_GRID = "launch_cooperative(reinterpret_cast<const void*>(fixpoint_kernel<S>), {}, args, s);"
GRID_SPLIT = {
    "vertex": [(_FIX_GRID.format("product_items(n, e)"), _FIX_GRID.format("n"))],
    "vertex and an edge": [(_FIX_GRID.format("product_items(n, e)"), _FIX_GRID.format("int64_t(n) + e"))],
}


# spmv.cu's pagerank_kernel with one phase of its iteration taken out (phase
# 16 (b): where an iteration's time goes); each variant loops max_iters
# times whatever its delta, and its ranks are not the kernel's
_RANK_LOOP = ("if (!(delta > tol && it < max_iters)) break;", "if (!(it < max_iters)) break;")
RANK_SPLIT = {
    "the tiles": [("    for (int t = blockIdx.x; t < tiles; t += gridDim.x)\n      rank_tile(",
                   "    for (int t = blockIdx.x; t < 0; t += gridDim.x)\n      rank_tile("), _RANK_LOOP],
    "the vertex phase": [("    rank_vertices<false>(off, d_off, in_window, rp, r, rn, n, e0, chunks, r0, base_in, "
                          "damping, dm);\n", ""), _RANK_LOOP],
}


def probe_source() -> str:
    """The path of GRID_SYNC_PROBE_CU, written under the port's build
    directory."""
    from gelly_streaming_tpu_torch.ops import _cuda

    path = _cuda.BUILD_DIR / "probe" / "grid_sync_probe.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    if not path.exists() or path.read_text() != GRID_SYNC_PROBE_CU:
        path.write_text(GRID_SYNC_PROBE_CU)
    return str(path)


def variant_spmv_fixpoint(lib):
    """The current fixpoint's C interface over ``lib`` (a GRID_SPLIT
    variant of spmv.cu), called as ``spmv.fixpoint_launch`` calls it:
    (x buffers, frontier, header)."""
    import torch
    from gelly_streaming_tpu_torch.ops import _cuda, spmv

    def fixpoint(sem, op, x0, fm0, thr, max_iters):
        c = op.capacity
        xs = torch.empty((2, c), dtype=x0.dtype, device=x0.device)
        fm = torch.empty((c,), dtype=torch.bool, device=x0.device)
        scratch = spmv._plan_scratch(lib, op)
        _cuda.check(lib.spmv_fixpoint_launch(
            sem.code, op.off.data_ptr(), op.s_dst.data_ptr(), op.s_w.data_ptr(), op.d_off.data_ptr(),
            op.d_src.data_ptr(), op.d_w.data_ptr(), op.n_active.data_ptr(), c, op.e_pad, x0.data_ptr(),
            fm0.data_ptr(), xs.data_ptr(), fm.data_ptr(), float(thr), int(max_iters), scratch.data_ptr(),
            scratch.numel() * 4, torch.cuda.current_stream(x0.device).cuda_stream), "variant spmv_fixpoint")
        return xs, fm, scratch[:24]

    return fixpoint


def variant_pagerank(lib):
    """The current pagerank_fixpoint's C interface over ``lib`` (a
    RANK_SPLIT variant of spmv.cu), called as ``spmv.pagerank_launch``
    calls it: fn(op, tol, max_iters) at damping 0.85."""
    import torch
    from gelly_streaming_tpu_torch.ops import _cuda

    def pagerank(op, tol, max_iters):
        c, dev = op.capacity, op.off.device
        rs = torch.empty((2, c), dtype=torch.float32, device=dev)
        in_w = torch.empty((c,), dtype=torch.bool, device=dev)
        scratch = torch.empty(((lib.pagerank_scratch_bytes(c, op.e_pad) + 3) // 4,), dtype=torch.int32, device=dev)
        _cuda.check(lib.pagerank_fixpoint_launch(
            op.off.data_ptr(), op.d_off.data_ptr(), op.d_src.data_ptr(), c, op.e_pad, 0.85, float(tol),
            int(max_iters), rs.data_ptr(), in_w.data_ptr(), scratch.data_ptr(), scratch.numel() * 4,
            torch.cuda.current_stream(dev).cuda_stream), "variant pagerank_fixpoint")

    return pagerank


def parent_pagerank(lib):
    """9717394's pagerank_fixpoint over ``lib`` (its C interface: the
    scratch sized by the vertices alone; one warp a 32-destination group, a
    hub's in-segment one warp's), called as its wrapper called it: (ranks
    [2, C], in_window, scratch: int32 slot 1 the iterations)."""
    import torch
    from gelly_streaming_tpu_torch.ops import _cuda

    def pagerank(op, damping, tol, max_iters):
        c, dev = op.capacity, op.off.device
        nbytes = lib.pagerank_scratch_bytes(c)
        if nbytes < 0:
            raise RuntimeError("parent pagerank_scratch_bytes: the occupancy query failed")
        rs = torch.empty((2, c), dtype=torch.float32, device=dev)
        in_w = torch.empty((c,), dtype=torch.bool, device=dev)
        scratch = torch.empty(((nbytes + 3) // 4,), dtype=torch.int32, device=dev)
        _cuda.check(lib.pagerank_fixpoint_launch(
            op.off.data_ptr(), op.d_off.data_ptr(), op.d_src.data_ptr(), c, float(damping), float(tol),
            int(max_iters), rs.data_ptr(), in_w.data_ptr(), scratch.data_ptr(), scratch.numel() * 4,
            torch.cuda.current_stream(dev).cuda_stream), "parent pagerank_fixpoint")
        return rs, in_w, scratch

    return pagerank


def parent_kcore_round(lib):
    """a48e429's kcore_round over ``lib`` (its C interface: two launches a
    bucket, a searched h-index, rows past 1024 staged in a buffer),
    updating c in place as its wrapper did."""
    import torch
    from gelly_streaming_tpu_torch.ops import _cuda

    def kcore_round(c, keys, nbrs, valid):
        k, d = nbrs.shape
        h = torch.empty((k,), dtype=torch.int32, device=c.device)
        stage = torch.empty((k, d), dtype=torch.int32, device=c.device) if d > 1024 else None
        _cuda.check(lib.kcore_round_launch(
            c.data_ptr(), c.shape[0], keys.data_ptr(), nbrs.data_ptr(), valid.data_ptr(), k, d, h.data_ptr(),
            None if stage is None else stage.data_ptr(), torch.cuda.current_stream(c.device).cuda_stream),
            "parent kcore_round")
        return c

    return kcore_round


def grid_sync_us(cpm, blocks: int) -> tuple:
    """(µs a grid-wide sync, ms of the launch with none) of a cooperative
    launch of ``blocks`` blocks of 256 threads (GRID_SYNC_PROBE_CU): the
    held device time of SYNC_PROBE syncs less that of none, over
    SYNC_PROBE."""
    import torch
    from gelly_streaming_tpu_torch.ops import _cuda

    lib = load_baseline(probe_source(), GRID_SYNC_SIGNATURES)

    def probe(syncs):
        def run():
            _cuda.check(lib.grid_sync_probe_launch(blocks, syncs, torch.cuda.current_stream().cuda_stream),
                        "grid_sync_probe_launch")
        return run

    none_ms = device_ms(probe(0), SP_REPS, cpm)[0]
    many_ms = device_ms(probe(SYNC_PROBE), SP_REPS, cpm)[0]
    return (many_ms - none_ms) / SYNC_PROBE * 1e3, none_ms


def csr_spmv_yardstick(op, r, cpm) -> dict:
    """One PageRank iteration's spread as one cuSPARSE CSR SpMV: ``torch.mv``
    of the dst-sorted copy (crow d_off, col d_src, unit values) by c = r /
    max(out_deg, 1), summed in f32.  Not the same function as the fixpoint
    (one iteration, f32 sums), a yardstick of its gathers' speed: {ms held,
    rel_err: the max relative difference from the f64 spread}, or {error}
    where the library call fails."""
    import torch
    from gelly_streaming_tpu_torch.ops import spmv

    c = op.capacity
    lo, hi = int(op.d_off[0]), int(op.d_off[c])
    col = op.d_src[lo:hi].contiguous()
    cvec = r / (op.off[1:] - op.off[:-1]).clamp_min(1).to(torch.float32)
    want = torch.zeros((c,), dtype=torch.float64, device=r.device).index_add_(
        0, spmv._segment_ids(op).long(), cvec[col.long()].double())
    try:
        a = torch.sparse_csr_tensor((op.d_off - lo).contiguous(), col,
                                    torch.ones((hi - lo,), dtype=torch.float32, device=r.device), size=(c, c),
                                    check_invariants=False)
        got = torch.mv(a, cvec)
        ms = device_ms(lambda: torch.mv(a, cvec), SP_REPS, cpm)[0]
    except RuntimeError as e:
        return {"error": f"torch.mv of a CSR tensor failed: {str(e)[:200]}"}
    sel = want > 0
    rel = float(((got.double() - want).abs()[sel] / want[sel]).max()) if bool(sel.any()) else 0.0
    return {"ms": ms, "rel_err": rel}


def phase_spmv(dev, cpm, cc_data: dict, parents=None, grid_variants=None, rank_variants=None) -> dict:
    """Phase 16: the SpMV core and its algorithms on the card at Graph500
    scale 20: (a) SSSP, (b) PageRank, (c) k-core, each held against its
    twin on the card and (a), (c) against scipy / numpy oracles; (d)
    iterative CC over the CC bench's stream; (e) the JAX bench's SpMV
    shape (with ``grid_variants``, {grid: fixpoint} of GRID_SPLIT's builds,
    each in turns with the current; ``rank_variants``, {phase taken out:
    pagerank} of RANK_SPLIT's builds).  ``parents``: {"spmv": 9717394's
    pagerank_fixpoint (parent_pagerank), "kcore": a48e429's round
    (parent_kcore_round)}, each timed in turns with the current kernel."""
    import torch
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.core.windows import WindowPane
    from gelly_streaming_tpu_torch.library import IterativeConnectedComponents, windowed_kcore, windowed_pagerank
    from gelly_streaming_tpu_torch.library import kcore as kc
    from gelly_streaming_tpu_torch.library import windowed_sssp
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
    from gelly_streaming_tpu_torch.ops import spmv
    from gelly_streaming_tpu_torch.ops import unionfind as uf
    from gelly_streaming_tpu_torch.utils import metrics

    parents = parents or {}
    res = {}
    t_phase = time.perf_counter()
    c = 1 << SP_SCALE
    rng = np.random.default_rng(SP_SEED)
    t0 = time.perf_counter()
    src, dst = rmat_edges(SP_SCALE, SP_EDGE_FACTOR, ET_RMAT_ABC, rng)
    w = rng.random(len(src), dtype=np.float32)
    n_win = len(src) // SP_WIN_EDGES
    wins = [slice(k * SP_WIN_EDGES, (k + 1) * SP_WIN_EDGES) for k in range(n_win)]
    log(f"  Graph500 Kronecker scale {SP_SCALE}, edge factor {SP_EDGE_FACTOR} (A, B, C = {ET_RMAT_ABC}, "
        f"default_rng({SP_SEED})): {len(src)} edges over C = {c}, weights U[0, 1) f32, {n_win} tumbling windows of "
        f"{SP_WIN_EDGES} edges ({time.perf_counter() - t0:.2f} s to generate)")
    base = StreamConfig(vertex_capacity=c, batch_size=SP_BATCH, ingest_window_edges=SP_WIN_EDGES)

    def blocks_of(out):
        return [tuple(np.asarray(col) for col in b.columns) for b in out.blocks()]

    def same_blocks(a, b) -> bool:
        return len(a) == len(b) and all(all(np.array_equal(x, y) for x, y in zip(p, q)) for p, q in zip(a, b))

    # (a) SSSP ---------------------------------------------------------------
    source = int(np.bincount(src[wins[0]], minlength=c).argmax())
    runs = {}
    for mode in ("auto", "push", "pull", "auto"):  # the first auto run warms the path
        cfg = dataclasses.replace(base, spmv_direction=mode)
        metrics.reset_spmv_stats()
        spmv.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks = blocks_of(windowed_sssp(sp_stream(src, dst, w, cfg, dev), source, WINDOW_MS))
        secs = time.perf_counter() - t0
        runs[mode] = (blocks, secs, metrics.spmv_stats(), dict(spmv.LAUNCHES))
    blocks, secs, stats, launches = runs["auto"]
    if launches["spmv_fixpoint"] != n_win:
        raise RuntimeError(f"(a): spmv_fixpoint launched {launches['spmv_fixpoint']} times for {n_win} windows")
    for mode in ("push", "pull"):
        if not same_blocks(runs[mode][0], blocks):
            raise RuntimeError(f"(a): {mode} distances differ from auto")
    log(f"  (a) windowed_sssp from vertex {source} (most out-edges in window 0): auto {secs:.3f} s "
        f"({len(src) / secs:.6g} edges/s), push {runs['push'][1]:.3f} s, pull {runs['pull'][1]:.3f} s; "
        f"distances bit-equal across modes; {sum(len(b[0]) for b in blocks)} records")
    log(f"      auto: {stats['spmv_iters_total']} iterations ({stats['spmv_push_iters']} push, "
        f"{stats['spmv_pull_iters']} pull, {stats['spmv_direction_switches']} switches), density histogram "
        f"{[stats[f'spmv_density_hist_{b}'] for b in range(metrics.SPMV_DENSITY_BINS)]}")
    a_rows, a_panes, a_err, oracle_s, rel = [], [], 0.0, 0.0, 0.0
    thr = spmv.resolve_threshold(base)
    for k, win in enumerate(wins):
        op = spmv.prepare_pane(src[win], dst[win], w[win], np.ones(SP_WIN_EDGES, bool), c, device=dev)
        x0 = torch.full((c,), spmv.MIN_PLUS.identity, dtype=torch.float32, device=dev)
        x0[source] = 0.0
        fm0 = x0 != spmv.MIN_PLUS.identity
        got = spmv._fixpoint_cuda(spmv.MIN_PLUS, op, x0, fm0, thr, c - 1)
        twin_log = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = spmv.fixpoint_plain(spmv.MIN_PLUS, op, x0, fm0, thr, c - 1, twin_log)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(got.x, want.x) and torch.equal(got.frontier, want.frontier)) or got[2:] != want[2:]:
            raise RuntimeError(f"(a) window {k}: the kernel differs from its twin: {got[2:]} against {want[2:]}")
        a_err = max(a_err, float((got.x - want.x).abs().max()))
        x = got.x.cpu().numpy()
        vids = np.nonzero(x < 1e30)[0]
        if not (np.array_equal(blocks[k][0], vids) and np.array_equal(blocks[k][1], x[vids])):
            raise RuntimeError(f"(a) window {k}: windowed_sssp's records differ from the kernel's x")
        t0 = time.perf_counter()
        ref = sssp_oracle(src[win], dst[win], w[win], c, source)
        oracle_s += time.perf_counter() - t0
        reached = np.isfinite(ref)
        if not np.array_equal(reached, x < 1e30):
            raise RuntimeError(f"(a) window {k}: reached set differs from scipy's "
                               f"({int(reached.sum())} against {int((x < 1e30).sum())})")
        r_err = float(np.max(np.abs(x[reached] - ref[reached]) / np.maximum(ref[reached], 1e-30)))
        if not np.allclose(x[reached], ref[reached], rtol=1e-5, atol=0):
            raise RuntimeError(f"(a) window {k}: distances off scipy's by {r_err} (rtol 1e-5)")
        rel = max(rel, r_err)
        a_rows.append({"iters": got.iters, "push": got.push_iters, "pull": got.pull_iters, "switches": got.switches,
                       "reached": int(reached.sum()), "plain_ms": plain_ms,
                       "bound_ms": fixpoint_bytes(twin_log, c, SP_WIN_EDGES) / HBM_BYTES_PER_S * 1e3})
        a_panes.append((op, x0, fm0, got.x))
    # each window's fixpoint in auto, forced push and forced pull, device
    # only
    fix_blocks = int(spmv.fixpoint_launch(spmv.MIN_PLUS, a_panes[0][0], a_panes[0][1], a_panes[0][2], thr,
                                          c - 1)[2][spmv.FIX_BLOCKS])
    sync_us, probe_ms = grid_sync_us(cpm, fix_blocks)
    for k, (op, x0, fm0, _) in enumerate(a_panes):
        for mode, t in (("auto", thr), ("push", 2.0), ("pull", -1.0)):
            a_rows[k][f"{mode}_ms"] = device_ms(
                lambda op=op, x0=x0, fm0=fm0, t=t: spmv.fixpoint_launch(spmv.MIN_PLUS, op, x0, fm0, t, c - 1),
                SP_REPS, cpm)[0]
    op, x0, fm0, x_auto = a_panes[0]

    def fix_fn(op=op, x0=x0, fm0=fm0):
        return spmv.fixpoint_launch(spmv.MIN_PLUS, op, x0, fm0, thr, c - 1)

    d_ms, h_us = device_ms(fix_fn, SP_REPS, cpm)
    fix_ms = cuda_ms(fix_fn, SP_REPS)
    pull_ms, push_ms = a_rows[0]["pull_ms"], a_rows[0]["push_ms"]
    sweep = {}
    for t in SP_SWEEP:  # auto's threshold on window 0: printed, the default stays
        run = spmv._fixpoint_cuda(spmv.MIN_PLUS, op, x0, fm0, t, c - 1)
        if not torch.equal(run.x, x_auto):
            raise RuntimeError(f"(a): the fixpoint at threshold {t} differs from auto's")
        sweep[t] = {"ms": device_ms(lambda t=t: spmv.fixpoint_launch(spmv.MIN_PLUS, op, x0, fm0, t, c - 1), SP_REPS,
                                    cpm)[0], "iters": run.iters, "push": run.push_iters, "pull": run.pull_iters}
    for k, row in enumerate(a_rows):
        log(f"      window {k}: {row['iters']} iterations ({row['push']} push, {row['pull']} pull, {row['switches']} "
            f"switches), {row['reached']} reached; twin {row['plain_ms']:.2f} ms; bound {row['bound_ms']:.5f} ms; "
            f"device held: auto {row['auto_ms']:.5f} ms ({row['auto_ms'] / row['bound_ms']:.2f}x), push "
            f"{row['push_ms']:.5f}, pull {row['pull_ms']:.5f}")
    log(f"      kernel = twin on the card (x, frontier, counters, histogram) and = windowed_sssp's records in every "
        f"window; reached sets = scipy's dijkstra, distances within rtol {rel:.3g} of its float64 "
        f"({oracle_s:.2f} s of scipy)")
    log(f"      spmv_fixpoint window 0: device {d_ms:.5f} ms held ({d_ms / a_rows[0]['bound_ms']:.2f}x its bound "
        f"{a_rows[0]['bound_ms']:.5f} ms), host {h_us:.2f} us a call, back-to-back events {fix_ms:.5f} ms; forced "
        f"pull {pull_ms:.5f} ms, forced push {push_ms:.5f} ms")
    log(f"      a grid-wide sync at the fixpoint's {fix_blocks} blocks of 256: {sync_us:.3f} us (a launch with none "
        f"{probe_ms:.5f} ms); window 0's {a_rows[0]['iters']} iterations take {2 * a_rows[0]['iters'] + 1} syncs, "
        f"{(2 * a_rows[0]['iters'] + 1) * sync_us / 1e3:.5f} ms")
    log("      auto's threshold on window 0 (the default stays " f"{thr}): " + "; ".join(
        f"{t}: {v['ms']:.5f} ms ({v['push']} push, {v['pull']} pull)" for t, v in sweep.items()))
    res["sssp"] = {"launches": launches["spmv_fixpoint"], "err": a_err, "ms": fix_ms, "device_ms": d_ms,
                   "host_us": h_us, "plain_ms": a_rows[0]["plain_ms"], "bound_ms": a_rows[0]["bound_ms"],
                   "edges_per_s": len(src) / secs, "windows": a_rows, "forced_pull_ms": pull_ms,
                   "forced_push_ms": push_ms, "scipy_rel_err": rel, "stats": stats,
                   "mode_s": {m: runs[m][1] for m in ("auto", "push", "pull")}, "blocks": fix_blocks,
                   "grid_sync_us": sync_us, "threshold_sweep": sweep}
    del a_panes

    # (b) PageRank -----------------------------------------------------------
    pr = {}
    for label, mode in (("push", ""), ("pull", "pull"), ("push2", "")):
        cfg = dataclasses.replace(base, spmv_direction=mode)
        metrics.reset_spmv_stats()
        spmv.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks = blocks_of(windowed_pagerank(sp_stream(src, dst, w, cfg, dev), WINDOW_MS, damping=0.85, tol=1e-6,
                                             max_iters=100))
        pr[label] = (blocks, time.perf_counter() - t0, metrics.spmv_stats(), dict(spmv.LAUNCHES))
    blocks, secs, stats, launches = pr["push2"]
    if not (same_blocks(pr["pull"][0], blocks) and same_blocks(pr["push"][0], blocks)):
        raise RuntimeError("(b): push, pull and a second run are not bit-identical")
    if launches["pagerank_fixpoint"] != n_win or pr["pull"][2]["spmv_pull_iters"] != stats["spmv_push_iters"]:
        raise RuntimeError(f"(b): launches {launches}, pull run {pr['pull'][2]}, push run {stats}")
    iters_total = stats["spmv_push_iters"]
    b_rows, pr_err, pr_rel = [], 0.0, 0.0
    parent_pr = parents.get("spmv")
    for k, win in enumerate(wins):
        op = spmv.prepare_pane(src[win], dst[win], None, np.ones(SP_WIN_EDGES, bool), c, device=dev)
        r, in_w, iters = spmv.pagerank_fixpoint(op, damping=0.85, tol=1e-6, max_iters=100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_r, want_in, want_it = spmv.pagerank_fixpoint_plain(op, damping=0.85, tol=1e-6, max_iters=100)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        vids = np.nonzero(in_w.cpu().numpy())[0]
        if not (np.array_equal(blocks[k][0], vids) and np.array_equal(blocks[k][1], r.cpu().numpy()[vids])):
            raise RuntimeError(f"(b) window {k}: windowed_pagerank's records differ from the kernel's ranks")
        if not torch.equal(in_w, want_in) or abs(iters - want_it) > 1:
            raise RuntimeError(f"(b) window {k}: in_window or iterations ({iters} against {want_it}) differ")
        if not torch.allclose(r, want_r, rtol=1e-5, atol=1e-9):
            raise RuntimeError(f"(b) window {k}: ranks off the twin's beyond rtol 1e-5 / atol 1e-9")
        total = float(r.double().sum())
        if abs(total - 1.0) > 1e-4:
            raise RuntimeError(f"(b) window {k}: ranks sum to {total}")
        pr_err = max(pr_err, float((r - want_r).abs().max()))
        sel = want_r > 0
        pr_rel = max(pr_rel, float(((r - want_r).abs()[sel] / want_r[sel]).max()))
        e_m = SP_WIN_EDGES
        row = {"iters": iters, "twin_iters": want_it, "vertices": len(vids), "sum": total, "plain_ms": plain_ms,
               "bound_ms": pagerank_bytes(iters, c, e_m) / HBM_BYTES_PER_S * 1e3}
        b_rows.append(row)

        def pr_fn(op=op):
            return spmv.pagerank_launch(op, damping=0.85, tol=1e-6, max_iters=100)

        row["blocks"] = int(pr_fn()[2][spmv.RANK_BLOCKS])
        row["ms"], row["host_us"] = device_ms(pr_fn, SP_REPS, cpm)
        if k == 0:
            pr_ms = cuda_ms(pr_fn, SP_REPS)
        if parent_pr is not None:  # 9717394's kernel: the same ranks, in_window and iterations first
            def old(op=op):
                return parent_pr(op, 0.85, 1e-6, 100)

            (ro, wo, so), (rc, wc, sc) = old(), pr_fn()
            if not (torch.equal(ro[0], rc[0]) and torch.equal(wo, wc) and int(so[1]) == int(sc[1])):
                raise RuntimeError(f"(b) window {k}: 9717394's pagerank_fixpoint and the current one differ")
            turns = in_turns(f"(b) window {k} pagerank_fixpoint, 9717394's and the current", old, pr_fn, SP_REPS,
                             cpm)
            row.update({"parent_ms": turns["parent_ms"], "turns_ms": turns["current_ms"], "turns": turns["turns"]})
        row["csr_spmv"] = csr_spmv_yardstick(op, r, cpm)
    for k, row in enumerate(b_rows):
        ys = row["csr_spmv"]
        log(f"      window {k}: {row['iters']} iterations (twin {row['twin_iters']}), {row['vertices']} vertices, "
            f"ranks sum {row['sum']:.7f}; twin {row['plain_ms']:.2f} ms; bound {row['bound_ms']:.5f} ms; device "
            f"{row['ms']:.5f} ms held ({row['ms'] / max(row['iters'], 1):.5f} ms an iteration, "
            f"{row['ms'] / row['bound_ms']:.2f}x its bound), host {row['host_us']:.2f} us a call, "
            f"{row['blocks']} blocks"
            + ("" if "parent_ms" not in row else f"; in turns 9717394's {row['parent_ms']:.5f} ms, the current "
               f"{row['turns_ms']:.5f} ms ({row['parent_ms'] / row['turns_ms']:.2f}x)")
            + (f"; yardstick {ys['error']}" if "error" in ys else
               f"; yardstick (not the same function: one iteration's spread, f32 sums) cuSPARSE CSR SpMV "
               f"{ys['ms']:.5f} ms, x {row['iters']} iterations {ys['ms'] * row['iters']:.5f} ms, max rel off the "
               f"f64 spread {ys['rel_err']:.3g}"))
    pr_d_ms, pr_h_us = b_rows[0]["ms"], b_rows[0]["host_us"]
    split = {}
    if rank_variants:  # window 0 at tol 0: every build runs SP_SPLIT_ITERS iterations
        op0 = spmv.prepare_pane(src[wins[0]], dst[wins[0]], None, np.ones(SP_WIN_EDGES, bool), c, device=dev)
        builds = {"none": lambda op, tol, iters: spmv.pagerank_launch(op, damping=0.85, tol=tol, max_iters=iters),
                  **rank_variants}
        for part, fn in builds.items():
            at = [device_ms(lambda fn=fn, i=i: fn(op0, 0.0, i), SP_REPS, cpm)[0] for i in (0, SP_SPLIT_ITERS)]
            split[part] = {"launch_ms": at[0], "us_an_iteration": (at[1] - at[0]) / SP_SPLIT_ITERS * 1e3}
        whole = split["none"]["us_an_iteration"]
        log(f"      window 0's iteration at tol 0 ({SP_SPLIT_ITERS} iterations; the launch and prologue "
            f"{split['none']['launch_ms']:.5f} ms): {whole:.2f} us; " + "; ".join(
                f"without {part} {v['us_an_iteration']:.2f} us (so {part} {whole - v['us_an_iteration']:.2f} us)"
                for part, v in split.items() if part != "none"))
    log(f"  (b) windowed_pagerank (damping 0.85, tol 1e-6, max_iters 100): {secs:.3f} s, "
        f"{iters_total * SP_WIN_EDGES / secs:.6g} edge-iterations/s end to end; push, pull and a second run "
        f"bit-identical; against the twin on the card: in_window exact, iterations within 1, ranks max abs "
        f"{pr_err:.3g}, max rel {pr_rel:.3g}")
    log(f"      pagerank_fixpoint window 0: device {pr_d_ms:.5f} ms held ({pr_d_ms / b_rows[0]['iters']:.5f} ms an "
        f"iteration; {pr_d_ms / b_rows[0]['bound_ms']:.2f}x its bound {b_rows[0]['bound_ms']:.5f} ms), host "
        f"{pr_h_us:.2f} us a call, back-to-back events {pr_ms:.5f} ms, {b_rows[0]['blocks']} blocks")
    res["pagerank"] = {"launches": launches["pagerank_fixpoint"], "err": pr_err, "rel_err": pr_rel, "ms": pr_ms,
                       "device_ms": pr_d_ms, "host_us": pr_h_us, "plain_ms": b_rows[0]["plain_ms"],
                       "bound_ms": b_rows[0]["bound_ms"], "ms_an_iteration": pr_d_ms / b_rows[0]["iters"],
                       "edge_iterations_per_s": iters_total * SP_WIN_EDGES / secs, "windows": b_rows,
                       "blocks": b_rows[0]["blocks"], "csr_spmv_yardstick": b_rows[0]["csr_spmv"],
                       "split_without": split}

    # (c) k-core -------------------------------------------------------------
    def twin_round(cc, keys, nbrs, valid):
        return cc.copy_(spmv.kcore_round_plain(cc, keys, nbrs, valid))

    parent_round = parents.get("kcore")
    spmv.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = blocks_of(windowed_kcore(sp_stream(src, dst, w, base, dev), WINDOW_MS))
    secs = time.perf_counter() - t0
    k_launches = dict(spmv.LAUNCHES)
    if k_launches["kcore_fixpoint"] != n_win or k_launches["kcore_round"]:
        raise RuntimeError(f"(c): launches {k_launches}, not one kcore_fixpoint launch a pane")
    c_rows, k_err, rb_err, round_launches = [], 0, 0, 0
    for k, win in enumerate(wins):
        t0 = time.perf_counter()
        simple = kc.simple_pane_edges(WindowPane(k, -1, src[win], dst[win], None, None), c)
        dedupe_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cores, rounds = kc.pane_cores(*simple, c, dev)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want, want_rounds = kc.pane_cores(*simple, c, dev, round_fn=twin_round)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if not torch.equal(cores, want) or rounds != want_rounds:
            raise RuntimeError(f"(c) window {k}: cores or rounds ({rounds}, {want_rounds}) differ from the twin's")
        k_err = max(k_err, int((cores - want).abs().max()))
        # the per-bucket route (one kcore_round C call a bucket a round)
        spmv.reset_launches()
        by_bucket, bb_rounds = kc.pane_cores(*simple, c, dev, round_fn=spmv.kcore_round)
        round_launches += spmv.LAUNCHES["kcore_round"]
        rb_err = max(rb_err, int((by_bucket - want).abs().max()))
        if not torch.equal(by_bucket, cores) or bb_rounds != rounds:
            raise RuntimeError(f"(c) window {k}: pane_cores through kcore_round differs from kcore_fixpoint's")
        h = cores.cpu().numpy()
        vids = np.nonzero(h > 0)[0]
        if not (np.array_equal(blocks[k][0], vids) and np.array_equal(blocks[k][1], h[vids])):
            raise RuntimeError(f"(c) window {k}: windowed_kcore's records differ")
        s_t, d_t, m_t = (torch.from_numpy(a).to(dev) for a in simple)
        buckets = [b for b in nbh.build_buckets(s_t, d_t, None, m_t) if b.num_keys > 0]
        table = spmv._kcore_table([(b.keys, b.nbrs, b.valid) for b in buckets], dev)
        bound = int(np.count_nonzero(simple[2])) + 1

        def one_round(cc, table=table):
            return spmv._kcore_fixpoint_launch(cc, table, 1)

        def sweep(cc, buckets=buckets, fn=spmv.kcore_round):
            for b in buckets:
                fn(cc, b.keys, b.nbrs, b.valid)
            return cc

        # each round of the main path replayed from the estimates it started
        # from (the degrees, then each round's result) through the new
        # kernel bounded at one round, and held equal to the per-bucket
        # kernels' round (and a48e429's) from the same start
        starts = [spmv.scatter_into(spmv.PLUS_ONE, c, s_t, torch.ones_like(s_t), m_t)]
        for _ in range(rounds):
            nxt = starts[-1].clone()
            one_round(nxt)
            starts.append(nxt)
        if not torch.equal(starts[-1], cores):
            raise RuntimeError(f"(c) window {k}: the replayed rounds do not reach pane_cores' cores")
        for r, (st, nxt) in enumerate(zip(starts[:-1], starts[1:])):
            if not torch.equal(sweep(st.clone()), nxt) or (
                    parent_round is not None and not torch.equal(sweep(st.clone(), fn=parent_round), nxt)):
                raise RuntimeError(f"(c) window {k} round {r + 1}: kcore_fixpoint's round differs from the "
                                   "per-bucket kernels'")
        cw = torch.empty_like(cores)
        copy_ms = device_ms(lambda: cw.copy_(starts[0]), SP_REPS, cpm)[0]
        timed = [device_ms(lambda st=st: one_round(cw.copy_(st)), SP_REPS, cpm) for st in starts[:-1]]
        round_ms = [d - copy_ms for d, _ in timed]

        def pane_fn(table=table, start=starts[0], bound=bound):
            return spmv._kcore_fixpoint_launch(cw.copy_(start), table, bound)

        pane_d, pane_h = device_ms(pane_fn, SP_REPS, cpm)
        row = {"rounds": rounds, "kmax": int(h.max()), "buckets": len(buckets),
               "widths": [b.nbrs.shape[1] for b in buckets][-3:], "dedupe_ms": dedupe_ms, "call_ms": call_ms,
               "round_ms": sum(round_ms) / rounds, "first_round_ms": round_ms[0], "last_round_ms": round_ms[-1],
               "max_round_ms": max(round_ms), "copy_ms": copy_ms, "round_host_us": sum(u for _, u in timed) / rounds,
               "pane_ms": pane_d - copy_ms, "pane_host_us": pane_h, "pane_events_ms": cuda_ms(pane_fn, 3),
               "plain_s": plain_s, "plain_sweep_ms": cuda_ms(lambda: sweep(cores.clone(), fn=twin_round), 2),
               "bound_ms": kcore_sweep_bytes(buckets) / HBM_BYTES_PER_S * 1e3}
        if k == 0:  # a grid sync at the launch's blocks; kcore_round's round
            core_blocks = int(pane_fn()[3])
            k_sync_us, _ = grid_sync_us(cpm, core_blocks)
            swept = [device_ms(lambda st=st: sweep(cw.copy_(st)), SP_REPS, cpm) for st in starts[:-1]]

            def replay(starts=starts):
                sweep(cw.copy_(starts[0]))
                for _ in range(len(starts) - 2):
                    sweep(cw)

            row.update({"sweep_ms": sum(d - copy_ms for d, _ in swept) / rounds,
                        "sweep_host_us": sum(u for _, u in swept) / rounds,
                        "sweep_events_ms": cuda_ms(replay, 2, warmup=1) / rounds})
        if parent_round is not None:  # a48e429's round and pane_cores, in turns with the current
            turns = []
            for st in starts[:-1]:
                got = [device_ms(fn, SP_REPS, cpm)[0] - copy_ms for fn in (
                    lambda st=st: sweep(cw.copy_(st), fn=parent_round), lambda st=st: one_round(cw.copy_(st)),
                    lambda st=st: one_round(cw.copy_(st)), lambda st=st: sweep(cw.copy_(st), fn=parent_round))]
                turns.append(got)
            walls = []
            for fn in (parent_round, None, None, parent_round):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                kc.pane_cores(*simple, c, dev, round_fn=fn)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            row.update({"parent_round_ms": sum(t[0] + t[3] for t in turns) / (2 * rounds),
                        "current_round_ms": sum(t[1] + t[2] for t in turns) / (2 * rounds),
                        "parent_call_ms": (walls[0] + walls[3]) / 2, "current_call_ms": (walls[1] + walls[2]) / 2,
                        "call_turns_ms": walls})
        c_rows.append(row)
        del starts, cw
    t0 = time.perf_counter()
    o_src, o_dst = rmat_edges(SP_ORACLE_SCALE, SP_EDGE_FACTOR, ET_RMAT_ABC, np.random.default_rng(SP_SEED))
    o_n = 1 << SP_ORACLE_SCALE
    o_cfg = StreamConfig(vertex_capacity=o_n, batch_size=1 << 16)
    got = windowed_kcore(EdgeStream.from_arrays(o_src, o_dst, o_cfg, device=dev), WINDOW_MS).collect()
    want = core_oracle(o_src, o_dst, o_n)
    if got != [(v, int(want[v])) for v in np.nonzero(want)[0]]:
        raise RuntimeError("(c): k-core differs from the peeling oracle on the scale-14 pane")
    log(f"  (c) windowed_kcore: {secs:.3f} s for {n_win} windows, {len(src) / secs:.6g} edges/s end to end, "
        f"kcore_fixpoint launched {k_launches['kcore_fixpoint']} times (one a pane), kcore_round "
        f"{k_launches['kcore_round']}; cores = the twin's on the card in every window, and = pane_cores through "
        f"kcore_round ({round_launches} C calls, one a bucket a round, max |err| against the twin {rb_err}); = "
        f"Batagelj-Zaversnik peeling on a "
        f"scale-{SP_ORACLE_SCALE} pane ({len(o_src)} edges, k_max {int(want.max())}; {time.perf_counter() - t0:.2f} s)")
    log(f"      a grid-wide sync at the k-core fixpoint's {core_blocks} blocks of 256: {k_sync_us:.3f} us")
    for k, row in enumerate(c_rows):
        log(f"      window {k}: {row['rounds']} rounds, k_max {row['kmax']}, {row['buckets']} buckets (widest "
            f"{row['widths']}); host dedupe {row['dedupe_ms']:.1f} ms; pane_cores {row['call_ms']:.2f} ms; the "
            f"fixed point in one launch, device held {row['pane_ms']:.5f} ms (host {row['pane_host_us']:.1f} us; "
            f"events {row['pane_events_ms']:.5f} ms); a round, each replayed from its own start through "
            f"kcore_fixpoint: mean {row['round_ms']:.5f} ms ({row['round_ms'] / row['bound_ms']:.2f}x its bound "
            f"{row['bound_ms']:.5f} ms), first (from the degrees) {row['first_round_ms']:.5f}, last "
            f"{row['last_round_ms']:.5f}, most {row['max_round_ms']:.5f} (a {row['copy_ms']:.5f} ms copy of the "
            f"start taken off each); twin's round {row['plain_sweep_ms']:.3f} ms, twin's pane {row['plain_s']:.2f} s"
            + ("" if "sweep_ms" not in row else f"; kcore_round's round (15 C calls): device {row['sweep_ms']:.5f} "
               f"ms, host {row['sweep_host_us']:.1f} us, back to back by events {row['sweep_events_ms']:.5f} ms")
            + ("" if "parent_round_ms" not in row else f"; in turns a round a48e429 {row['parent_round_ms']:.5f} "
               f"ms, current {row['current_round_ms']:.5f} ({row['parent_round_ms'] / row['current_round_ms']:.2f}x)"
               f", pane_cores a48e429 {row['parent_call_ms']:.2f} ms, current {row['current_call_ms']:.2f} ms"))
    row0 = c_rows[0]
    res["kcore"] = {"launches": k_launches["kcore_fixpoint"], "err": k_err, "ms": row0["pane_events_ms"],
                    "device_ms": row0["pane_ms"], "host_us": row0["pane_host_us"], "plain_ms": row0["plain_s"] * 1e3,
                    "bound_ms": row0["bound_ms"] * row0["rounds"], "round_ms": row0["round_ms"],
                    "round_bound_ms": row0["bound_ms"], "edges_per_s": len(src) / secs, "windows": c_rows,
                    "blocks": core_blocks, "grid_sync_us": k_sync_us}
    # kcore_round is not on windowed_kcore's path on the card since the
    # one-launch fixed point: its launches are that path's (0, from the same
    # reset as kcore_fixpoint's); the per-bucket route's C calls stand apart
    res["kcore_round"] = {"launches": k_launches["kcore_round"], "side_route_launches": round_launches,
                          "err": rb_err, "ms": row0["sweep_events_ms"],
                          "device_ms": row0["sweep_ms"], "host_us": row0["sweep_host_us"],
                          "plain_ms": row0["plain_sweep_ms"], "bound_ms": row0["bound_ms"]}

    # (d) iterative CC ---------------------------------------------------------
    n_ic = SP_IC_BATCHES * CC_BATCH
    i_src, i_dst = cc_data["src"][:n_ic], cc_data["dst"][:n_ic]
    i_cfg = StreamConfig(vertex_capacity=CC_VERTICES, batch_size=CC_BATCH)
    IterativeConnectedComponents().run(EdgeStream.from_arrays(i_src[:4096], i_dst[:4096], i_cfg, batch_size=2048,
                                                              device=dev)).collect()  # warm
    ic = IterativeConnectedComponents()
    uf.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ic_blocks = blocks_of(ic.run(EdgeStream.from_arrays(i_src, i_dst, i_cfg, device=dev)))
    ic_s = time.perf_counter() - t0
    ic_launches = uf.LAUNCHES["union_kernel"]
    n_rec = sum(len(b[0]) for b in ic_blocks)

    def twin_cc(p, s, a, b, m):
        p2, s2 = uf.union_edges_with_seen_plain(p, s, a, b, m)
        return p.copy_(p2), s.copy_(s2)

    ic2 = IterativeConnectedComponents()
    ic2._kernel = twin_cc
    twin_blocks = blocks_of(ic2.run(EdgeStream.from_arrays(i_src, i_dst, i_cfg, device=dev)))
    want_parent, _ = cc_oracle(i_src, i_dst, CC_VERTICES)
    if ic_launches != SP_IC_BATCHES or not same_blocks(ic_blocks, twin_blocks):
        raise RuntimeError(f"(d): {ic_launches} union launches; records equal to the twin's: "
                           f"{same_blocks(ic_blocks, twin_blocks)}")
    if not (np.array_equal(ic.final_labels, want_parent) and np.array_equal(ic2.final_labels, want_parent)):
        raise RuntimeError("(d): final labels differ from scipy's connected components")
    log(f"  (d) IterativeConnectedComponents over the CC bench's first {SP_IC_BATCHES} batches of {CC_BATCH}: "
        f"{ic_s:.3f} s, {n_rec / ic_s:.6g} records/s, {n_ic / ic_s:.6g} edges/s ({n_rec} records, union_kernel "
        f"launched {ic_launches} times); every block = the twin's run on the card, final labels = scipy's")
    res["iterative_cc"] = {"launches": ic_launches, "records_per_s": n_rec / ic_s, "edges_per_s": n_ic / ic_s,
                           "records": n_rec, "seconds": ic_s}

    # (e) the JAX bench's SpMV shape ----------------------------------------------
    rng = np.random.default_rng(SP_BENCH_SEED)
    b_src = ((rng.zipf(1.2, SP_BENCH_E) - 1) % SP_BENCH_C).astype(np.int32)
    b_dst = rng.integers(0, SP_BENCH_C, SP_BENCH_E).astype(np.int32)
    b_w = rng.random(SP_BENCH_E).astype(np.float32)
    ones = np.ones((SP_BENCH_E,), bool)
    op = spmv.prepare_pane(b_src, b_dst, b_w, ones, SP_BENCH_C, device=dev)
    dist0 = torch.full((SP_BENCH_C,), spmv.MIN_PLUS.identity, dtype=torch.float32, device=dev)
    dist0[0] = 0.0

    def run(direction):
        out = spmv.fixpoint(spmv.MIN_PLUS, op, dist0, max_iters=SP_BENCH_C - 1, direction=direction)
        torch.cuda.synchronize()
        return out

    op_pr = spmv.prepare_pane(b_src, b_dst, None, ones, SP_BENCH_C, device=dev)

    def run_pr():
        _, _, iters = spmv.pagerank_fixpoint(op_pr, damping=0.85, tol=1e-6, max_iters=50)
        torch.cuda.synchronize()
        return iters

    outs = {d: run(d) for d in ("auto", "push", "pull")}
    if not all(torch.equal(outs[d].x, outs["auto"].x) for d in ("push", "pull")):
        raise RuntimeError("(e): auto, push and pull differ")
    run_pr()

    def wall(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    trials = [(wall(lambda: run("auto")), wall(lambda: run("push"))) for _ in range(3)]
    auto_w, push_w = min(t for t, _ in trials), min(t for _, t in trials)
    t0 = time.perf_counter()
    pr_iters = run_pr()
    pr_w = time.perf_counter() - t0
    e_auto = outs["auto"]
    e_x0 = dist0.contiguous()
    e_fm0 = e_x0 != spmv.MIN_PLUS.identity
    e_sweep = {}
    for t in SP_SWEEP:  # auto's threshold at the bench's shape: printed, the default stays
        run_t = spmv._fixpoint_cuda(spmv.MIN_PLUS, op, e_x0, e_fm0, t, SP_BENCH_C - 1)
        if not torch.equal(run_t.x, e_auto.x):
            raise RuntimeError(f"(e): the fixpoint at threshold {t} differs from auto's")
        e_sweep[t] = {"ms": device_ms(lambda t=t: spmv.fixpoint_launch(spmv.MIN_PLUS, op, e_x0, e_fm0, t,
                                                                        SP_BENCH_C - 1), SP_REPS, cpm)[0],
                      "iters": run_t.iters, "push": run_t.push_iters, "pull": run_t.pull_iters}
    thr_e = spmv.DEFAULT_DIRECTION_THRESHOLD

    def e_fix(fn=spmv.fixpoint_launch, t=thr_e):
        return fn(spmv.MIN_PLUS, op, e_x0, e_fm0, t, SP_BENCH_C - 1)

    e_blocks = int(e_fix()[2][spmv.FIX_BLOCKS])
    e_grid = {"blocks": e_blocks}
    for grid, fn in (grid_variants or {}).items():  # a thread a vertex (and an edge), in turns
        vx, vf, vh = e_fix(fn)
        xc, fc, hc = e_fix()
        if not (torch.equal(vx[0], xc[0]) and torch.equal(vf, fc) and torch.equal(vh[:15], hc[:15])):
            raise RuntimeError(f"(e): the fixpoint with a thread a {grid} differs")
        e_grid[grid] = {"blocks": int(vh[spmv.FIX_BLOCKS])}
        for mode, t in (("auto", thr_e), ("push", 2.0), ("pull", -1.0)):
            e_grid[grid][mode] = in_turns(
                f"(e) spmv_fixpoint {mode}, a thread a {grid} ({e_grid[grid]['blocks']} blocks) as the parent, the "
                f"current grid ({e_blocks})", lambda fn=fn, t=t: e_fix(fn, t), lambda t=t: e_fix(t=t), SP_REPS, cpm)
    log(f"  (e) the JAX bench's SpMV shape (C = {SP_BENCH_C}, {SP_BENCH_E} edges, Zipf 1.2 sources, "
        f"default_rng({SP_BENCH_SEED})): force-push / auto wall {push_w / auto_w:.4f} (auto {auto_w * 1e3:.3f} ms, "
        f"push {push_w * 1e3:.3f} ms; auto {e_auto.iters} iterations: {e_auto.push_iters} push, "
        f"{e_auto.pull_iters} pull); PageRank {pr_iters} iterations, {SP_BENCH_E * pr_iters / pr_w:.6g} "
        f"edge-iterations/s; auto, push and pull bit-equal")
    log("      auto's threshold at this shape, the fixpoint device held (the default stays "
        f"{spmv.DEFAULT_DIRECTION_THRESHOLD}): " + "; ".join(
            f"{t}: {v['ms']:.5f} ms ({v['push']} push, {v['pull']} pull)" for t, v in e_sweep.items()))
    log(f"      the fixpoint's grid at this shape: {e_blocks} blocks of 256 (a block a pull tile)" + "".join(
        f"; a thread a {grid}, {v['blocks']} blocks, in turns (device held, that / current): " + ", ".join(
            f"{m} {v[m]['parent_ms']:.5f} / {v[m]['current_ms']:.5f} ms ({v[m]['parent_ms'] / v[m]['current_ms']:.2f}x)"
            for m in ("auto", "push", "pull")) for grid, v in e_grid.items() if grid != "blocks"))
    res["bench"] = {"spmv_direction_speedup": push_w / auto_w, "auto_ms": auto_w * 1e3, "push_ms": push_w * 1e3,
                    "pagerank_eps": SP_BENCH_E * pr_iters / pr_w, "iters": e_auto.iters,
                    "push_iters": e_auto.push_iters, "pull_iters": e_auto.pull_iters, "threshold_sweep": e_sweep,
                    "grid": e_grid}
    log(f"  phase 16: {time.perf_counter() - t_phase:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 17: the spanner, the weighted matching and the sampled triangle
# estimators

F32_OPS_PER_S = 67e12  # the data sheet's non-tensor f32 rate; int32 runs at most as fast on the card
SUM_SP_VERTICES = 512  # (a): `measurements spanner` defaults (examples/measurements.py:827-841)
SUM_SP_EDGES = 1 << 17
SUM_SP_DEGREE = 64
SUM_SP_BATCH = 1 << 14
SUM_SP3_VERTICES = 4096  # (b): BASELINE.md's scaled shape, k = 3
SUM_SP3_EDGES = 1 << 19  # its 524,288 edges
SUM_MT_VERTICES = 1 << 12  # (d): `measurements matching` defaults (:842-846)
SUM_MT_EDGES = 1 << 16
SUM_MT_BATCH = 1 << 13
LOOP_TURNS = 8  # (d): rounds of (shipped, other, other, shipped) run loops timed in turns
ML_USERS, ML_ITEMS, ML_RATINGS = 943, 1682, 100_000  # a MovieLens-100K-shaped stream, generated
ML_CAPACITY = 4096
SUM_TRI_EDGES = 1 << 20  # (e): phase 15 (a)'s stream, its first 2^20 edges (cut for the twin's time)
SUM_TRI_BATCH = 1 << 16
SUM_TRI_SAMPLERS = 1000  # the example's default
SUM_REPS = 5
THREEFRY_OPS = 80  # integer operations of one coin: the hash (20 rounds, 5 injections) and the uniform's compare


def spanner_oracle(src, dst, capacity: int, max_degree: int, k: int) -> np.ndarray:
    """The sequential k-spanner in plain Python, independent of both
    packages: rows as lists in insertion order; an edge is admitted when
    no path of <= k hops joins its ends (a breadth-first search) and both
    rows have room.  Returns the [C, D] table (-1 = empty)."""
    rows = [[] for _ in range(capacity)]
    for u, v in zip(src.tolist(), dst.tolist()):
        reached, frontier = {u}, [u]
        for _ in range(k):
            nxt = []
            for x in frontier:
                for y in rows[x]:
                    if y not in reached:
                        reached.add(y)
                        nxt.append(y)
            frontier = nxt
        if v in reached or len(rows[u]) >= max_degree or len(rows[v]) >= max_degree:
            continue
        rows[u].append(v)
        rows[v].append(u)
    table = np.full((capacity, max_degree), -1, np.int32)
    for x, r in enumerate(rows):
        table[x, : len(r)] = r
    return table


def tensor_err(got, want) -> float:
    """Max abs difference over paired tensors (bools and uint32 as int64)."""
    import torch

    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return float("inf")
        if g.dtype in (torch.bool, torch.uint32):
            g, w = g.cpu().to(torch.int64), w.cpu().to(torch.int64)
        if g.numel():
            worst = max(worst, float((g.double() - w.double()).abs().max()))
    return worst


def copies_events_ms(call, make_copy, reps: int) -> float:
    """ms per ``call(copy)`` by CUDA events around back-to-back calls, each
    on its own ``make_copy()`` made before the first."""
    import torch

    copies = [make_copy() for _ in range(reps)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for cp in copies:
        call(cp)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def held_ms(fn, cycles_per_ms: float, hold_ms: float = 1.0) -> float:
    """Device ms of one call of ``fn``, enqueued while ``torch.cuda._sleep``
    holds the stream (the call's own device time, its enqueue hidden)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_ms * cycles_per_ms))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def host_ms(fn) -> float:
    """ms of one synchronized call of ``fn`` on the host's clock."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def timed_run(fn):
    """(result, seconds) of one synchronized run of ``fn``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class spanner_twin:
    """Within the block, the spanner's admission is its plain twin (the
    library looks ``ops/spanner.spanner_admit`` up at each call)."""

    def __enter__(self):
        from gelly_streaming_tpu_torch.ops import spanner as sp

        self.saved = sp.spanner_admit
        sp.spanner_admit = sp.spanner_admit_plain

    def __exit__(self, *exc):
        from gelly_streaming_tpu_torch.ops import spanner as sp

        sp.spanner_admit = self.saved


def kernel_timing(cpm, call, make_copy, twin, bound_ms: float, reps: int = SUM_REPS) -> dict:
    """A kernel's call timed on copies of its input state: device ms on the
    held stream and host enqueue µs, events back to back, the twin's ms
    once on the host's clock, the bound and the ratio."""
    d_ms, h_us = copies_device_ms(call, make_copy, reps, cpm)
    ms = copies_events_ms(call, make_copy, reps)
    cp = make_copy()
    plain_ms = host_ms(lambda: twin(cp))
    return {"device_ms": d_ms, "host_us": h_us, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "ratio": d_ms / bound_ms}


def parent_spanner_call(lib):
    """c34004e's spanner admission over ``lib`` (the capped pre-filter, a
    warp an edge, then one 1024-thread block resolving every candidate):
    call(nbrs, deg, src, dst, mask, k, cap, body), in place, with its own
    int32[4] stats."""
    import torch
    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import spanner as sp

    bufs = {}

    def call(nbrs, deg, src, dst, mask, k, cap, body):
        dev = nbrs.device
        n, (c, d) = src.shape[0], nbrs.shape
        code = sp.BODIES.index(body)
        key = (dev, n, c, d, k, cap, code)
        if key not in bufs:
            nbytes = int(lib.spanner_scratch_bytes(n, c, d, k, cap, code))
            bufs[key] = (torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev),
                         torch.zeros((4,), dtype=torch.int32, device=dev))
        buf, st = bufs[key]
        _cuda.check(lib.spanner_admit_launch(
            nbrs.data_ptr(), deg.data_ptr(), c, d, src.data_ptr(), dst.data_ptr(),
            None if mask is None else mask.data_ptr(), n, k, cap, code, buf.data_ptr(), buf.numel(), st.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "parent spanner_admit_launch")

    return call


def parent_sampler_call(lib):
    """c34004e's sampler scan over ``lib`` (the key chain on one thread of
    the card, then the step keys, coin, finish, hits and seen kernels):
    call(state, src, dst, mask), in place."""
    import torch
    from gelly_streaming_tpu_torch.ops import _cuda

    bufs = {}

    def call(state, src, dst, mask):
        dev = state.edge.device
        n, s_lanes = src.shape[0], state.edge.shape[0]
        if (dev, n, s_lanes) not in bufs:
            nbytes = int(lib.sampler_scratch_bytes(n, s_lanes))
            bufs[dev, n, s_lanes] = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)
        buf = bufs[dev, n, s_lanes]
        _cuda.check(lib.sampler_scan_launch(
            state.key.data_ptr(), state.edge.data_ptr(), state.third.data_ptr(), state.closed_a.data_ptr(),
            state.closed_b.data_ptr(), state.edges_seen.data_ptr(), state.seen.data_ptr(), s_lanes,
            state.seen.shape[0], src.data_ptr(), dst.data_ptr(), None if mask is None else mask.data_ptr(), n,
            buf.data_ptr(), buf.numel(), torch.cuda.current_stream(dev).cuda_stream), "parent sampler_scan_launch")

    return call


def parent_matching_call(lib):
    """5030d41's matching scan over ``lib`` (one thread walks the batch,
    the state in global memory): call(partner, weight, src, dst, val,
    mask) -> (events, emask), the state updated in place."""
    import torch
    from gelly_streaming_tpu_torch.ops import _cuda

    def call(partner, weight, src, dst, val, mask):
        dev = partner.device
        n = src.shape[0]
        events = torch.empty((n, 3, 4), dtype=torch.float32, device=dev)
        emask = torch.empty((n, 3), dtype=torch.bool, device=dev)
        _cuda.check(lib.matching_scan_launch(
            partner.data_ptr(), weight.data_ptr(), partner.shape[0], src.data_ptr(), dst.data_ptr(),
            None if val is None else val.data_ptr(), None if mask is None else mask.data_ptr(), n, events.data_ptr(),
            emask.data_ptr(), torch.cuda.current_stream(dev).cuda_stream), "parent matching_scan_launch")
        return events, emask

    return call


def measured_in_turns(measure, parent, current) -> dict:
    """``measure(fn)`` for parent, current, current, parent: the four
    readings, each side's mean and current / parent."""
    got = [(tag, measure(fn)) for tag, fn in (("parent", parent), ("current", current), ("current", current),
                                              ("parent", parent))]
    p = sum(ms for tag, ms in got if tag == "parent") / 2
    c = sum(ms for tag, ms in got if tag == "current") / 2
    return {"turns": got, "parent_ms": p, "current_ms": c, "ratio": c / p}


def turns_text(t: dict) -> str:
    return (", ".join(f"{tag} {ms:.4f}" for tag, ms in t["turns"]) +
            f" ms: current / parent {t['ratio']:.4f} ({t['parent_ms'] / max(t['current_ms'], 1e-9):.2f}x faster)")


def cpu_model() -> str:
    """lscpu's model name of the host, or "not known"."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "not known"
    names = [line.split(":", 1)[1].strip() for line in out.splitlines() if line.startswith("Model name")]
    if names and names[0] not in ("", "-", "unknown"):
        return names[0]
    try:  # lscpu may not name a virtual CPU; /proc/cpuinfo may
        with open("/proc/cpuinfo") as f:
            names = [line.split(":", 1)[1].strip() for line in f if line.startswith("model name")]
    except OSError:
        names = []
    return f"lscpu: {names and names[0] or 'not known'}"


def phase_matching(dev, cpm, parents) -> dict:
    """Phase 17 (d): ``CentralizedWeightedMatching.run`` over both streams,
    every batch held against the twin and the plan (its rounds from the
    device counters), the one-batch-deep run loop against the blocking
    one in turns, the last batches and the evicting chain timed, and
    5030d41's scan in turns where ``parents`` holds it."""
    import torch
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.core.types import EdgeBatch
    from gelly_streaming_tpu_torch.library import matching as lm
    from gelly_streaming_tpu_torch.ops import matching as mo
    from gelly_streaming_tpu_torch.utils.value_types import MatchingEvent

    # (d) the greedy matching: `measurements matching` defaults, then a MovieLens-100K-shaped stream
    def weighted_stream(s, d, w, c, batch):
        cfg_m = StreamConfig(vertex_capacity=c, batch_size=batch)
        arrays = [to_dev((s[i:i + batch], d[i:i + batch], w[i:i + batch]), dev) for i in range(0, len(s), batch)]

        def factory():
            for a, b, x in arrays:
                yield EdgeBatch.from_arrays(a, b, val=x, pad_to=batch, device=dev)

        return EdgeStream.from_batches(factory, cfg_m, device=dev), cfg_m

    def blocking_run(stream, cfg_m):
        """5030d41's run loop: each batch's events and emask read back by a
        blocking ``.cpu()`` before the next batch's scan is enqueued."""
        state = lm.init_matching(cfg_m, dev)
        out = []
        for batch in stream.batches():
            state, events, emask = lm.matching_update(state, batch.src, batch.dst, batch.val, batch.mask)
            e_h, m_h = events.cpu().numpy(), emask.cpu().numpy()
            for i, slot in zip(*np.nonzero(m_h)):
                t, a, b, x = e_h[i, slot]
                out.append(MatchingEvent("ADD" if t > 0.5 else "REMOVE", int(a), int(b), float(x)).as_tuple())
        return out

    def loops_in_turns(shipped, other):
        """Each run loop's walls (s) over LOOP_TURNS rounds of shipped,
        other, other, shipped: the walls, median, quartiles, min and max of
        each, the medians' ratio, and the pairs (each run with its
        neighbour in the round) the shipped loop won."""
        walls = {"shipped": [], "other": []}
        for _ in range(LOOP_TURNS):
            for tag, fn in (("shipped", shipped), ("other", other), ("other", other), ("shipped", shipped)):
                walls[tag].append(timed_run(fn)[1])
        out = {tag: {"walls_s": w, "median_s": float(np.median(w)), "q1_s": float(np.percentile(w, 25)),
                     "q3_s": float(np.percentile(w, 75)), "min_s": min(w), "max_s": max(w)}
               for tag, w in walls.items()}
        out["shipped_over_other"] = out["shipped"]["median_s"] / out["other"]["median_s"]
        out["shipped_won_pairs"] = sum(a < b for a, b in zip(walls["shipped"], walls["other"]))
        out["pairs"] = 2 * LOOP_TURNS
        return out

    def scan_timing(p0, w0, b, name):
        """The scan on (p0, w0) before batch ``b``: the kernel held against
        the twin and the plan (rounds from the device counters), timed on
        copies of the state, and the parent in turns."""
        n = b.src.shape[0]
        c = p0.shape[0]
        val = None if b.val is None else b.val.to(torch.float32).contiguous()
        cp, tw, pl = [(p0.clone(), w0.clone()) for _ in range(3)]
        mo.reset_stats()
        got = mo.matching_scan(*cp, b.src, b.dst, val, b.mask)
        st = mo.stats(dev)
        want = mo.matching_scan_plain(*tw, b.src, b.dst, val, b.mask)
        *plan, rounds = mo.matching_rounds_plain(*pl, b.src, b.dst, val, b.mask, mo.WINDOW)
        err = max(tensor_err((*got, *cp), (*want, *tw)), tensor_err((*plan, *pl), (*want, *tw)))
        if err or st["calls"] != 1 or st["rounds"] != rounds:
            raise RuntimeError(f"(d) {name}: the scan differs from its twin (max abs err {err}) or its rounds "
                               f"{st['rounds']} from the plan's {rounds}")
        bound = (n * (4 + 4 + 4 + 1 + 48 + 3) + 2 * c * 8) / HBM_BYTES_PER_S * 1e3
        t = kernel_timing(cpm, lambda cp: mo.matching_scan(cp[0], cp[1], b.src, b.dst, val, b.mask),
                          lambda: (p0.clone(), w0.clone()),
                          lambda cp: mo.matching_scan_plain(cp[0], cp[1], b.src, b.dst, val, b.mask), bound)
        t.update(rounds=rounds, admitted=st["admitted"], serial_steps=n, window=mo.WINDOW,
                 ns_an_edge=t["device_ms"] * 1e6 / n)
        log(f"  (d) {name}: {n} edges over C {c} ({'shared' if mo.state_in_shared(c) else 'global'} state), "
            f"{st['admitted']} admitted, {rounds} rounds at window {mo.WINDOW} (the plan's; {n} serial steps): "
            f"device {t['device_ms']:.4f} ms held ({t['ns_an_edge']:.1f} ns an edge, "
            f"{t['device_ms'] * 1e3 / rounds:.3f} us a round), events {t['ms']:.4f} ms, host enqueue "
            f"{t['host_us']:.2f} us, twin {t['plain_ms']:.1f} ms, bound {bound:.6f} ms (bytes), {t['ratio']:.1f}x")
        if "matching" in parents:
            old = parents["matching"]
            cp_old, cp_new = (p0.clone(), w0.clone()), (p0.clone(), w0.clone())
            got_old = old(*cp_old, b.src, b.dst, val, b.mask)
            got_new = mo.matching_scan(*cp_new, b.src, b.dst, val, b.mask)
            if tensor_err((*got_old, *cp_old), (*got_new, *cp_new)):
                raise RuntimeError(f"(d) {name}: the parent's events or state differ from the current kernel's")
            t["turns"] = measured_in_turns(
                lambda fn: copies_device_ms(lambda cp: fn(cp[0], cp[1], b.src, b.dst, val, b.mask),
                                            lambda: (p0.clone(), w0.clone()), SUM_REPS, cpm)[0],
                old, mo.matching_scan)
            log(f"      in turns with 5030d41 (one thread), device ms held: {turns_text(t['turns'])}")
        return t

    rng = np.random.default_rng(0)
    ms_ = rng.integers(0, SUM_MT_VERTICES, SUM_MT_EDGES).astype(np.int32)
    md_ = rng.integers(0, SUM_MT_VERTICES, SUM_MT_EDGES).astype(np.int32)
    mw_ = rng.random(SUM_MT_EDGES).astype(np.float32)
    rng = np.random.default_rng(100)
    pairs = rng.choice(ML_USERS * ML_ITEMS, ML_RATINGS, replace=False)
    ml = ((pairs // ML_ITEMS).astype(np.int32), (ML_USERS + pairs % ML_ITEMS).astype(np.int32),
          rng.integers(1, 6, ML_RATINGS).astype(np.float32))
    match = {}
    for name, (s, d, w, c) in (("uniform", (ms_, md_, mw_, SUM_MT_VERTICES)),
                               ("movielens", (*ml, ML_CAPACITY))):
        stream, cfg_m = weighted_stream(s, d, w, c, SUM_MT_BATCH)
        lm.CentralizedWeightedMatching().run(stream).collect()  # warm the path
        mo.reset_launches()
        algo = lm.CentralizedWeightedMatching()
        recs, secs_m = timed_run(lambda: algo.run(stream).collect())
        n_launch = mo.LAUNCHES["matching_scan"]
        if n_launch != -(-len(s) // SUM_MT_BATCH) or mo.TWIN_CALLS["matching_scan"]:
            raise RuntimeError(f"(d) {name}: matching_scan was not the main path's one C call a batch: {n_launch}")
        if blocking_run(stream, cfg_m) != recs:
            raise RuntimeError(f"(d) {name}: the blocking run loop's records differ from the main path's")
        loops = loops_in_turns(lambda: lm.CentralizedWeightedMatching().run(stream).collect(),
                               lambda: blocking_run(stream, cfg_m))
        state = lm.init_matching(cfg_m, dev)
        twin = lm.MatchingState(state.partner.clone(), state.weight.clone())
        err_m, loop_recs, m_states, busy_m, rounds = 0.0, 0, [], 0.0, []
        for batch in stream.batches():
            before = (state.partner.clone(), state.weight.clone())
            m_states.append((*before, batch))
            got = []
            mo.reset_stats()
            busy_m += held_ms(lambda: got.extend(mo.matching_scan(state.partner, state.weight, batch.src, batch.dst,
                                                                  batch.val, batch.mask)), cpm)
            st = mo.stats(dev)
            ev, em = got
            ev2, em2 = mo.matching_scan_plain(twin.partner, twin.weight, batch.src, batch.dst, batch.val, batch.mask)
            pl = (before[0].clone(), before[1].clone())
            *plan, r_plan = mo.matching_rounds_plain(*pl, batch.src, batch.dst, batch.val, batch.mask, mo.WINDOW)
            if st["calls"] != 1 or st["rounds"] != r_plan:
                raise RuntimeError(f"(d) {name}: batch {len(rounds)} took {st['rounds']} rounds, the plan {r_plan}")
            rounds.append(r_plan)
            err_m = max(err_m, tensor_err((ev, em, state.partner, state.weight), (ev2, em2, twin.partner, twin.weight)),
                        tensor_err((*plan, *pl), (ev, em, state.partner, state.weight)))
            loop_recs += int(em.sum())
        if err_m or len(recs) != loop_recs or tensor_err(tuple(algo.final_state), tuple(state)):
            raise RuntimeError(f"(d) {name}: the matching differs from its twin or its plan on the card (max abs err "
                               f"{err_m}) or the main path's records and state from the batch loop's")
        lp, lw, lb = m_states[-1]
        idle_m = 100 * (1 - busy_m / (secs_m * 1e3))
        for tag in ("shipped", "other"):
            loops[tag]["idle_pct"] = 100 * (1 - busy_m / (loops[tag]["median_s"] * 1e3))
        matched = int((state.partner >= 0).sum()) // 2
        log(f"  (d) matching, {name}: {len(s)} edges over C {c} in batches of {SUM_MT_BATCH}: {secs_m:.4f} s end "
            f"to end, {len(s) / secs_m:.6g} edges/s, {len(recs)} events, {matched} matched; launches {n_launch}; "
            f"every batch's events, emask and state equal to the twin and to the plan on the card, its rounds "
            f"(window {mo.WINDOW}) equal to the plan's: {rounds}; the calls {busy_m:.4f} ms of device time (each "
            f"held) against the run's {secs_m * 1e3:.1f} ms: idle {idle_m:.2f}%; in turns ({LOOP_TURNS} rounds of "
            "shipped, other, other, shipped), walls in ms median (quartiles) [min, max]: " + ", ".join(
                f"{label} {loops[tag]['median_s'] * 1e3:.2f} ({loops[tag]['q1_s'] * 1e3:.2f}, "
                f"{loops[tag]['q3_s'] * 1e3:.2f}) [{loops[tag]['min_s'] * 1e3:.2f}, "
                f"{loops[tag]['max_s'] * 1e3:.2f}], idle {loops[tag]['idle_pct']:.2f}%"
                for tag, label in (("shipped", "the run loop (one batch deep)"),
                                   ("other", "5030d41's blocking loop (a .cpu() a batch)"))) +
            f"; shipped / other {loops['shipped_over_other']:.4f}, the shipped loop won "
            f"{loops['shipped_won_pairs']} of {loops['pairs']} pairs")
        t_m = scan_timing(lp, lw, lb, f"{name}, the last batch")
        match[name] = {**t_m, "launches": n_launch, "err": err_m, "edges": len(s), "s": secs_m,
                       "edges_per_s": len(s) / secs_m, "records": len(recs), "matched": matched,
                       "rounds_a_batch": rounds, "idle_pct": idle_m, "busy_ms": busy_m, "loops_in_turns": loops}
    # every lane conflicts: each admission evicts the row the next edge reads, one edge a round
    n = SUM_MT_BATCH
    c = 2 * n + 1
    p0 = torch.full((c,), -1, dtype=torch.int32, device=dev)
    p0[:2 * n] = torch.arange(2 * n, device=dev, dtype=torch.int32) ^ 1
    w0 = torch.zeros((c,), dtype=torch.float32, device=dev)
    w0[:2 * n] = 1.0
    chain_src = torch.cat([torch.tensor([2 * n]), 2 * torch.arange(1, n) - 1]).to(torch.int32)
    chain = EdgeBatch.from_arrays(*to_dev((chain_src.numpy(), (2 * np.arange(n)).astype(np.int32),
                                           np.full(n, 3.0, np.float32)), dev), device=dev)
    match["chain"] = scan_timing(p0, w0, chain, "the evicting chain (pairs (2i, 2i + 1) matched at weight 1; edge e "
                                 "(2e - 1, 2e) at weight 3)")
    if match["chain"]["rounds"] != n:
        raise RuntimeError(f"(d) the chain took {match['chain']['rounds']} rounds, not one an edge")
    return match


def phase_summaries(dev, cpm, parents=None) -> dict:
    """Phase 17: ``Spanner`` (a)-(c), ``CentralizedWeightedMatching`` (d) and
    ``BroadcastTriangleCount`` (e) through their entry points on the card,
    each kernel held against its twin on the card (the spanner's (b)
    against the plain model of its two phases); ``parents``: c34004e's
    spanner and sampler calls, timed in turns with the current ones."""
    import torch
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library import sampled_triangles as lst
    from gelly_streaming_tpu_torch.library import spanner as lsp
    from gelly_streaming_tpu_torch.ops import sampled_triangles as sto
    from gelly_streaming_tpu_torch.ops import spanner as sp
    from gelly_streaming_tpu_torch.summaries import adjacency
    from gelly_streaming_tpu_torch.utils import threefry

    parents = parents or {}
    res = {}
    # (a) the k = 2 spanner at `measurements spanner`'s defaults, through the wire path
    rng = np.random.default_rng(0)
    src = rng.integers(0, SUM_SP_VERTICES, SUM_SP_EDGES).astype(np.int32)
    dst = rng.integers(0, SUM_SP_VERTICES, SUM_SP_EDGES).astype(np.int32)
    cfg = StreamConfig(vertex_capacity=SUM_SP_VERTICES, max_degree=SUM_SP_DEGREE, batch_size=SUM_SP_BATCH)

    def spanner_run(s, d, k=2, body="auto", c=cfg):
        return EdgeStream.from_arrays(s, d, c, device=dev).aggregate(lsp.Spanner(1000, k, body=body)).collect()

    spanner_run(src[:SUM_SP_BATCH], dst[:SUM_SP_BATCH])  # warm the path
    sp.reset_launches()
    sp.reset_stats()
    out, secs = timed_run(lambda: spanner_run(src, dst))
    launches = dict(sp.LAUNCHES)
    stats_a = sp.stats(dev)
    if launches["spanner_admit"] != SUM_SP_EDGES // SUM_SP_BATCH or sp.TWIN_CALLS["spanner_admit"]:
        raise RuntimeError(f"(a): spanner_admit was not the main path's one C call a batch: {launches}")
    final = out[-1][0]
    nbrs, deg = adjacency.init_table(SUM_SP_VERTICES, SUM_SP_DEGREE, dev)
    tn, td = nbrs.clone(), deg.clone()
    err, states, twin_s, busy, per_batch = 0.0, [], 0.0, 0.0, []
    for b in range(SUM_SP_EDGES // SUM_SP_BATCH):
        s_t, d_t = to_dev((src[b * SUM_SP_BATCH:(b + 1) * SUM_SP_BATCH], dst[b * SUM_SP_BATCH:(b + 1) * SUM_SP_BATCH]),
                          dev)
        states.append((nbrs.clone(), deg.clone(), s_t, d_t))
        # the plain model's pre-pass on the table before the batch
        cand_m = ~sp.prefilter_plain(nbrs, s_t, d_t, 2, 128)
        surv_m = int(sp.exact_prepass_plain(nbrs, s_t, d_t, cand_m, 2, "within_two").sum())
        st0 = sp.stats(dev)
        busy += held_ms(lambda: sp.spanner_admit(nbrs, deg, s_t, d_t, None, 2, 128, "within_two"), cpm)
        st1 = sp.stats(dev)
        got = (st1["candidates"] - st0["candidates"], st1["survivors"] - st0["survivors"])
        if got != (int(cand_m.sum()), surv_m):
            raise RuntimeError(f"(a) batch {b}: the kernel's candidates and survivors {got} differ from the model's "
                               f"{(int(cand_m.sum()), surv_m)}")
        per_batch.append(got)
        t0 = time.perf_counter()
        sp.spanner_admit_plain(tn, td, s_t, d_t, None, 2, 128, "within_two")
        torch.cuda.synchronize()
        twin_s += time.perf_counter() - t0
        err = max(err, tensor_err((nbrs, deg), (tn, td)))
        if b == 0:
            oracle = spanner_oracle(src[:SUM_SP_BATCH], dst[:SUM_SP_BATCH], SUM_SP_VERTICES, SUM_SP_DEGREE, 2)
            if not np.array_equal(nbrs.cpu().numpy(), oracle):
                raise RuntimeError("(a): the first batch's spanner differs from the sequential Python oracle")
    if err or tensor_err((final.nbrs, final.deg), (nbrs, deg)):
        raise RuntimeError(f"(a): the spanner differs from its twin on the card (max abs err {err}) or the main "
                           "path's table from the batch loop's")
    edges_a = int((nbrs >= 0).sum()) // 2
    late = states[-1]
    n_late = late[2].shape[0]
    bound = (n_late * 8 + 2 * (SUM_SP_VERTICES * SUM_SP_DEGREE + SUM_SP_VERTICES) * 4) / HBM_BYTES_PER_S * 1e3

    def sp_call(body, k, st):
        return lambda cp: sp.spanner_admit(cp[0], cp[1], st[2], st[3], None, k, 128, body)

    def sp_copy(st):
        return lambda: (st[0].clone(), st[1].clone())

    before = sp.stats(dev)
    timing = kernel_timing(cpm, sp_call("within_two", 2, late), sp_copy(late),
                           lambda cp: sp.spanner_admit_plain(cp[0], cp[1], late[2], late[3], None, 2, 128,
                                                             "within_two"), bound)
    after = sp.stats(dev)
    calls = after["calls"] - before["calls"]
    timing["candidates"] = (after["candidates"] - before["candidates"]) / max(calls, 1)
    timing["survivors"] = (after["survivors"] - before["survivors"]) / max(calls, 1)
    timing["us_a_survivor"] = timing["device_ms"] * 1e3 / max(timing["survivors"], 1)
    first = states[0]
    timing["first_batch_device_ms"], _ = copies_device_ms(sp_call("within_two", 2, first), sp_copy(first), 3, cpm)
    timing["first_batch_survivors"] = per_batch[0][1]
    timing["first_batch_us_a_survivor"] = timing["first_batch_device_ms"] * 1e3 / max(per_batch[0][1], 1)
    idle = 100 * (1 - busy / (secs * 1e3))
    res["spanner"] = {**timing, "launches": launches["spanner_admit"], "err": err, "edges_per_s": SUM_SP_EDGES / secs,
                      "s": secs, "spanner_edges": edges_a, "stats": stats_a, "twin_s": twin_s, "idle_pct": idle,
                      "busy_ms": busy, "per_batch": per_batch}
    log(f"  (a) Spanner k=2 over {SUM_SP_EDGES} edges (C {SUM_SP_VERTICES}, D {SUM_SP_DEGREE}, batches of "
        f"{SUM_SP_BATCH}): {secs:.4f} s end to end, {SUM_SP_EDGES / secs:.6g} edges/s, {edges_a} spanner edges; "
        f"launches {launches}; capped candidates {stats_a['candidates']} of {SUM_SP_EDGES}, survivors of the exact "
        f"pre-pass {stats_a['survivors']}, admitted {stats_a['admitted']}, most in a batch "
        f"{stats_a['max_candidates']} / {stats_a['max_survivors']}; (candidates, survivors) a batch {per_batch}, each "
        f"equal to the plain model's; every batch equal to the twin on the card (twin {twin_s:.2f} s for the 8 "
        f"batches), batch 0 equal to the sequential Python oracle")
    log(f"      the last batch ({timing['candidates']:.0f} candidates, {timing['survivors']:.0f} survivors): device "
        f"{timing['device_ms']:.4f} ms held ({timing['us_a_survivor']:.3f} us a survivor), events "
        f"{timing['ms']:.4f} ms, host enqueue {timing['host_us']:.2f} us, twin {timing['plain_ms']:.1f} ms, bound "
        f"{bound:.6f} ms (bytes), {timing['ratio']:.1f}x; batch 0 (from the empty table, {per_batch[0][1]} "
        f"survivors) {timing['first_batch_device_ms']:.4f} ms held ({timing['first_batch_us_a_survivor']:.3f} us a "
        f"survivor); the 8 calls {busy:.4f} ms of device time (each held) against the run's {secs * 1e3:.1f} ms: "
        f"idle {idle:.2f}%")
    if "spanner" in parents:
        old = parents["spanner"]
        for name, st, reps in (("late", late, SUM_REPS), ("batch0", first, 3)):
            cp_old, cp_new = sp_copy(st)(), sp_copy(st)()
            old(cp_old[0], cp_old[1], st[2], st[3], None, 2, 128, "within_two")
            sp_call("within_two", 2, st)(cp_new)
            if tensor_err(cp_old, cp_new):
                raise RuntimeError(f"(a) {name}: the parent's table differs from the current kernel's")
            t = measured_in_turns(lambda fn: copies_device_ms(fn, sp_copy(st), reps, cpm)[0],
                         lambda cp: old(cp[0], cp[1], st[2], st[3], None, 2, 128, "within_two"),
                         sp_call("within_two", 2, st))
            res["spanner"][f"turns_{name}"] = t
            log(f"      in turns with c34004e, (a) {name}: {turns_text(t)}")
        current = sp.spanner_admit

        def parent_admit(nbrs_, deg_, s_, d_, mask_, k_, cap_, body_):
            old(nbrs_, deg_, s_.contiguous(), d_.contiguous(), None if mask_ is None else mask_.contiguous(), k_,
                cap_, body_)
            return nbrs_, deg_

        def path_ms(admit):
            sp.spanner_admit = admit  # the library looks it up at each call
            try:
                return timed_run(lambda: spanner_run(src, dst))[1] * 1e3
            finally:
                sp.spanner_admit = current

        t = measured_in_turns(path_ms, parent_admit, current)
        res["spanner"]["turns_path"] = t
        log(f"      in turns with c34004e, (a)'s path end to end (host clock): {turns_text(t)}")
    split_a = {}
    for name, st in (("late", late), ("batch0", first)):
        rows = profiler_device_us(lambda: sp_call("within_two", 2, st)(sp_copy(st)()), 3)
        split_a[name] = {k_: round(us, 2) for k_, (us, _calls) in rows.items()
                         if any(kn in k_ for kn in ("prepass_kernel", "walk_kernel"))}
        split_a[name] = {("prepass_kernel" if "prepass_kernel" in k_ else "walk_kernel"): v
                         for k_, v in split_a[name].items()}
    res["spanner"]["split_us"] = split_a
    log(f"      by kernel (profiler, us): {split_a or 'not measured (no rows)'}")

    # (b) k = 3 at C = 4096: every body, the same table
    rng = np.random.default_rng(0)
    src3 = rng.integers(0, SUM_SP3_VERTICES, SUM_SP3_EDGES).astype(np.int32)
    dst3 = rng.integers(0, SUM_SP3_VERTICES, SUM_SP3_EDGES).astype(np.int32)
    cfg3 = StreamConfig(vertex_capacity=SUM_SP3_VERTICES, max_degree=SUM_SP_DEGREE, batch_size=SUM_SP_BATCH)
    tables, runs = {}, {}
    for body in ("auto", "balls", "bfs"):
        sp.reset_stats()
        out3, secs3 = timed_run(lambda: spanner_run(src3, dst3, 3, body, cfg3))
        tables[body] = (out3[-1][0].nbrs, out3[-1][0].deg)
        runs[body] = {"s": secs3, "edges_per_s": SUM_SP3_EDGES / secs3, **sp.stats(dev)}
    err_b = max(tensor_err(tables["auto"], tables[b]) for b in ("balls", "bfs"))
    if err_b:
        raise RuntimeError(f"(b): the bodies' k=3 spanners differ (max abs err {err_b})")
    runs["spanner_edges"] = int((tables["auto"][0] >= 0).sum()) // 2
    runs["auto_body"] = body3 = lsp.auto_body(SUM_SP3_VERTICES, SUM_SP_DEGREE, 3)
    res["spanner_k3"] = runs
    rates = ", ".join(f"{b} {runs[b]['edges_per_s']:.6g}" for b in ("auto", "balls", "bfs"))
    log(f"  (b) Spanner k=3 over {SUM_SP3_EDGES} edges (C {SUM_SP3_VERTICES}, D {SUM_SP_DEGREE}): auto "
        f"(= {body3}) {runs['auto']['s']:.3f} s, balls {runs['balls']['s']:.3f} s, bfs {runs['bfs']['s']:.3f} s "
        f"({rates} edges/s; the three {sum(runs[b]['s'] for b in ('auto', 'balls', 'bfs')):.3f} s); capped "
        f"candidates {runs['auto']['candidates']}, survivors of the exact pre-pass {runs['auto']['survivors']} "
        f"({runs['auto']['candidates'] / max(runs['auto']['survivors'], 1):.2f}x fewer walked), admitted "
        f"{runs['auto']['admitted']}; the three tables equal ({runs['spanner_edges']} edges)")
    # every batch of the auto run against the plain model: the capped test and the exact pre-pass on the card
    # (vectorized over the batch), the walk over the survivors on the host
    b3 = [to_dev((src3[i:i + SUM_SP_BATCH], dst3[i:i + SUM_SP_BATCH]), dev)
          for i in range(0, SUM_SP3_EDGES, SUM_SP_BATCH)]
    nb, db = adjacency.init_table(SUM_SP3_VERTICES, SUM_SP_DEGREE, dev)
    nm, dm = nb.cpu(), db.cpu()
    model_s, b_counts = 0.0, []
    for i, (s_t, d_t) in enumerate(b3):
        t0 = time.perf_counter()
        cand_m = ~sp.prefilter_plain(nb, s_t, d_t, 3, 128)
        surv_m = sp.exact_prepass_plain(nb, s_t, d_t, cand_m, 3, body3)
        want = (int(cand_m.sum()), int(surv_m.sum()))
        sp.walk_plain(nm, dm, s_t.cpu(), d_t.cpu(), surv_m.cpu(), 3, body3)
        model_s += time.perf_counter() - t0
        st0 = sp.stats(dev)
        sp.spanner_admit(nb, db, s_t, d_t, None, 3, 128, body3)
        st1 = sp.stats(dev)
        got = (st1["candidates"] - st0["candidates"], st1["survivors"] - st0["survivors"])
        if got != want or tensor_err((nb.cpu(), db.cpu()), (nm, dm)):
            raise RuntimeError(f"(b) batch {i}: the kernel's candidates and survivors {got} or its table differ "
                               f"from the plain model's {want}")
        b_counts.append(got)
    if tensor_err((nb, db), tables["auto"]):
        raise RuntimeError("(b): the batch loop's table differs from the main path's")

    halves_ms = {}

    def replay(admit, body):
        """(device ms by events, table) of (b)'s whole run as C calls, one a batch, from the empty table; the
        first half's ms (2^18 edges, the smoke's earlier cut) into ``halves_ms``."""
        n_, d_ = adjacency.init_table(SUM_SP3_VERTICES, SUM_SP_DEGREE, dev)
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(b3) + 1)]
        marks[0].record()
        for i, (s_t, d_t) in enumerate(b3):
            admit(n_, d_, s_t, d_t, None, 3, 128, body)
            marks[i + 1].record()
        torch.cuda.synchronize()
        halves_ms[admit, body] = marks[0].elapsed_time(marks[len(b3) // 2])
        halves_ms[admit, body, "batches"] = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return marks[0].elapsed_time(marks[-1]), (n_, d_)

    for body in (body3, "bfs"):
        ms3, table3 = replay(sp.spanner_admit, body)
        if tensor_err(table3, tables["auto"]):
            raise RuntimeError(f"(b) {body}: the replay's table differs from the main path's")
        surv3 = runs["auto"]["survivors"]
        runs[f"{body}_device_ms"] = ms3
        runs[f"{body}_first_half_ms"] = halves_ms[sp.spanner_admit, body]
        runs[f"{body}_us_a_survivor"] = ms3 * 1e3 / max(surv3, 1)
        per = halves_ms[sp.spanner_admit, body, "batches"]
        runs[f"{body}_batch_ms"] = per
        rows = profiler_device_us(lambda: replay(sp.spanner_admit, body), 1)
        split = {kn: round(us * calls / 1e3, 3) for k_, (us, calls) in rows.items()
                 for kn in ("prepass_kernel", "walk_kernel") if kn in k_}
        runs[f"{body}_split_ms"] = split
        line = (f"      (b) {body}, the run's C calls alone: device {ms3:.3f} ms (events; the first "
                f"{SUM_SP3_EDGES // 2} edges {halves_ms[sp.spanner_admit, body]:.3f} ms), "
                f"{ms3 * 1e3 / max(surv3, 1):.3f} us a survivor; batch 0 {per[0]:.3f} ms "
                f"({per[0] * 1e3 / max(b_counts[0][1], 1):.3f} us a survivor), the last batch {per[-1]:.3f} ms "
                f"({per[-1] * 1e3 / max(b_counts[-1][1], 1):.3f} us a survivor); by kernel over the run "
                f"(profiler, ms) {split or 'not measured (no rows)'}")
        if "spanner" in parents:
            if tensor_err(replay(parents["spanner"], body)[1], tables["auto"]):
                raise RuntimeError(f"(b) {body}: the parent's table differs from the current kernel's")
            t = measured_in_turns(lambda fn: replay(fn, body)[0], parents["spanner"], sp.spanner_admit)
            t["parent_first_half_ms"] = halves_ms[parents["spanner"], body]
            runs[f"turns_{body}"] = t
            line += (f"; in turns with c34004e: {turns_text(t)}; the parent's first {SUM_SP3_EDGES // 2} edges "
                     f"{t['parent_first_half_ms']:.3f} ms")
        log(line)
    runs["per_batch"] = b_counts
    log(f"      (candidates, survivors) a batch {b_counts}, each equal to the plain model's and every batch's table "
        f"to the model's walk ({model_s:.1f} s: the pre-pass on the card, the walk on the host)")

    # (c) combine: (a)'s two halves' spanners, on the card and through the twin
    half = SUM_SP_EDGES // 2
    halves = [spanner_run(src[i:i + half], dst[i:i + half])[-1][0] for i in (0, half)]
    agg = lsp.Spanner(1000, 2)

    def states_of():
        return [lsp.SpannerState(g.nbrs.clone(), g.deg.clone()) for g in halves]

    sp.reset_stats()
    combined, comb_s = timed_run(lambda: agg.combine(*states_of()))
    comb_stats = sp.stats(dev)
    with spanner_twin():
        twin_comb, twin_comb_s = timed_run(lambda: agg.combine(*states_of()))
    err_c = tensor_err(combined, twin_comb)
    if err_c:
        raise RuntimeError(f"(c): the combined spanner differs from the twin's (max abs err {err_c})")
    res["combine"] = {"s": comb_s, "twin_s": twin_comb_s, "err": err_c, **comb_stats,
                      "spanner_edges": int((combined.nbrs >= 0).sum()) // 2}
    log(f"  (c) combine of (a)'s halves' spanners ({[int((g.nbrs >= 0).sum()) // 2 for g in halves]} edges): "
        f"{comb_s * 1e3:.2f} ms on the card ({comb_stats['candidates']} candidates, {comb_stats['survivors']} "
        f"survivors of {SUM_SP_VERTICES * SUM_SP_DEGREE} slots), twin {twin_comb_s:.2f} s, equal "
        f"({res['combine']['spanner_edges']} edges)")

    res["matching"] = phase_matching(dev, cpm, parents)

    # (e) BroadcastTriangleCount(1000) over phase 15 (a)'s Watts-Strogatz stream
    ws_s, ws_d = watts_strogatz(ET_VERTICES, 16, 0.1, np.random.default_rng(5))
    ws_s, ws_d = ws_s[:SUM_TRI_EDGES], ws_d[:SUM_TRI_EDGES]
    cfg_t = StreamConfig(vertex_capacity=ET_VERTICES, batch_size=SUM_TRI_BATCH)
    t_stream = EdgeStream.from_arrays(ws_s, ws_d, cfg_t, device=dev)
    lst.BroadcastTriangleCount(SUM_TRI_SAMPLERS).run(
        EdgeStream.from_arrays(ws_s[:SUM_TRI_BATCH], ws_d[:SUM_TRI_BATCH], cfg_t, device=dev)).collect()  # warm
    sto.reset_launches()
    tri_algo = lst.BroadcastTriangleCount(SUM_TRI_SAMPLERS)
    estimates, secs_t = timed_run(lambda: tri_algo.run(t_stream).collect())
    n_launch = sto.LAUNCHES["sampler_scan"]
    if n_launch != SUM_TRI_EDGES // SUM_TRI_BATCH or sto.TWIN_CALLS["sampler_scan"]:
        raise RuntimeError(f"(e): sampler_scan was not the main path's one C call a batch: {n_launch}")
    # the run loop by hand: was batch k + 1's chain done while the card still ran batch k?
    state = lst.init_samplers(cfg_t, SUM_TRI_SAMPLERS, device=dev)
    chain = sto.KeyChain(threefry.seed(0xDEADBEEF), dev)
    ready, ahead_ms = 0, []
    for batch in t_stream.batches():
        sto.sampler_scan(state, batch.src, batch.dst, batch.mask, chain)
        done = torch.cuda.Event()
        done.record()
        t0 = time.perf_counter()
        chain.ahead(SUM_TRI_BATCH)
        ahead_ms.append((time.perf_counter() - t0) * 1e3)
        ready += not done.query()
        lst.estimate(state)
    state = lst.init_samplers(cfg_t, SUM_TRI_SAMPLERS, device=dev)
    twin = sto.clone_state(state)
    chain = sto.KeyChain(threefry.seed(0xDEADBEEF), dev)
    err_t, twin_t, t_states, busy_t = 0.0, 0.0, [], 0.0
    for i, batch in enumerate(t_stream.batches()):
        keys = chain.take(batch.src.shape[0]).clone()
        t_states.append((sto.clone_state(state), batch, keys))
        busy_t += held_ms(lambda: sto.scan_launch(state, batch.src, batch.dst, batch.mask, keys), cpm)
        t0 = time.perf_counter()
        sto.sampler_scan_plain(twin, batch.src, batch.dst, batch.mask)
        torch.cuda.synchronize()
        twin_t += time.perf_counter() - t0
        est, est_twin = lst.estimate(state), lst.estimate(twin)
        err_t = max(err_t, tensor_err(tuple(state), tuple(twin)), abs(est - est_twin))
        if est != estimates[i][0]:
            raise RuntimeError(f"(e): batch {i}'s estimate {est} differs from the main path's {estimates[i][0]}")
    if err_t or tensor_err(tuple(tri_algo.final_state), tuple(state)):
        raise RuntimeError(f"(e): the samplers differ from their twin on the card (max abs err {err_t}) or the main "
                           "path's final state from the batch loop's")
    before, lb, lkeys = t_states[-1]
    n = lb.src.shape[0]
    # the coins this batch needs: each lane's from the batch's end back to its last replacement
    last = sto.coin_walk(before, lb.mask)[3]
    coins = int((n - last.clamp_min(0)).sum())
    bytes_t = n * 9 + (n + 1) * 8 + 2 * (8 + SUM_TRI_SAMPLERS * 14 + ET_VERTICES + 4)
    bound_bytes, bound_ops = bytes_t / HBM_BYTES_PER_S * 1e3, coins * THREEFRY_OPS / F32_OPS_PER_S * 1e3
    t_t = kernel_timing(cpm, lambda cp: sto.scan_launch(cp, lb.src, lb.dst, lb.mask, lkeys),
                        lambda: sto.clone_state(before),
                        lambda cp: sto.sampler_scan_plain(cp, lb.src, lb.dst, lb.mask), max(bound_bytes, bound_ops))
    split = profiler_device_us(lambda: sto.scan_launch(sto.clone_state(before), lb.src, lb.dst, lb.mask, lkeys), 3)
    split = {re.split(r"[<(]", key.replace("(anonymous namespace)::", "").removeprefix("void "))[0].split("::")[-1]:
             round(us, 2) for key, (us, _calls) in split.items() if "kernel" in key}
    # the op's host cost a call with the chain computed ahead (the copy and the launch), and the chain alone
    op_us = []
    for _ in range(SUM_REPS):
        cp = sto.clone_state(before)
        ch = sto.KeyChain(threefry.key_ints(before.key), dev)
        ch.ahead(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sto.sampler_scan(cp, lb.src, lb.dst, lb.mask, ch)
        op_us.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    host_keys = torch.empty((n + 1, 2), dtype=torch.int32)
    chain_ns = []
    for _ in range(SUM_REPS):
        t0 = time.perf_counter()
        sto.host_chain(threefry.key_ints(before.key), n, host_keys)
        chain_ns.append((time.perf_counter() - t0) * 1e9 / n)
    if not torch.equal(host_keys, lkeys.cpu()):
        raise RuntimeError("(e): the host chain differs from the keys the batch loop handed over")
    model = cpu_model()
    idle_t = 100 * (1 - busy_t / (secs_t * 1e3))
    res["sampler"] = {**t_t, "launches": n_launch, "err": err_t, "edges": SUM_TRI_EDGES, "s": secs_t,
                      "edges_per_s": SUM_TRI_EDGES / secs_t, "estimate": estimates[-1][0], "twin_s": twin_t,
                      "bound_by": "operations" if bound_ops >= bound_bytes else "bytes", "coins": coins,
                      "serial_steps": 0, "split_us": split, "idle_pct": idle_t, "busy_ms": busy_t,
                      "op_host_us": min(op_us), "host_chain_ns_a_hash": min(chain_ns), "host_cpu": model,
                      "chain_ahead_ms": ahead_ms, "keys_ready_while_card_busy": ready,
                      "batches": len(ahead_ms)}
    log(f"  (e) BroadcastTriangleCount({SUM_TRI_SAMPLERS}) over the first {SUM_TRI_EDGES} edges of phase 15 (a)'s "
        f"Watts-Strogatz stream (C {ET_VERTICES}, batches of {SUM_TRI_BATCH}): {secs_t:.4f} s end to end, "
        f"{SUM_TRI_EDGES / secs_t:.6g} edges/s, estimate {estimates[-1][0]:.6g}; launches {n_launch}; every batch's "
        f"state (key included) and estimate equal to the twin on the card (twin {twin_t:.2f} s); the last batch: "
        f"device {t_t['device_ms']:.4f} ms held, events {t_t['ms']:.4f} ms, host enqueue {t_t['host_us']:.2f} us "
        f"(the launch), {min(op_us):.2f} us the op with its keys computed ahead (copy and launch), twin "
        f"{t_t['plain_ms']:.1f} ms; by kernel (profiler, us) {split or 'not measured (no rows)'}; bound "
        f"{t_t['bound_ms']:.6f} ms ({res['sampler']['bound_by']}: {coins} coins x {THREEFRY_OPS} ops at "
        f"{F32_OPS_PER_S:.3g}/s; bytes {bound_bytes:.6f} ms), {t_t['ratio']:.1f}x; the calls {busy_t:.4f} ms "
        f"of device time (each held) against the run's {secs_t * 1e3:.1f} ms: idle {idle_t:.2f}%")
    log(f"      the host chain: {min(chain_ns):.2f} ns a hash ({n} hashes, best of {SUM_REPS}; {model}); in the run "
        f"loop batch k + 1's keys took {min(ahead_ms):.3f}-{max(ahead_ms):.3f} ms and were ready while the card "
        f"still ran batch k in {ready} of {len(ahead_ms)} batches")
    if "sampler" in parents:
        old = parents["sampler"]
        cp_old, cp_new = sto.clone_state(t_states[0][0]), sto.clone_state(t_states[0][0])
        b0 = t_states[0][1]
        old(cp_old, b0.src, b0.dst, b0.mask)
        sto.scan_launch(cp_new, b0.src, b0.dst, b0.mask, t_states[0][2])
        if tensor_err(tuple(cp_old), tuple(cp_new)):
            raise RuntimeError("(e): the parent's sampler state differs from the current kernel's")

        def batches_ms(fn):
            return sum(copies_device_ms(lambda cp, st=st: fn(cp, st), lambda st=st: sto.clone_state(st[0]), 1,
                                        cpm)[0] for st in t_states)

        t = measured_in_turns(batches_ms, lambda cp, st: old(cp, st[1].src, st[1].dst, st[1].mask),
                     lambda cp, st: sto.scan_launch(cp, st[1].src, st[1].dst, st[1].mask, st[2]))
        res["sampler"]["turns_batches"] = t
        log(f"      in turns with c34004e, (e)'s {len(t_states)} batches, device ms summed (each call held): "
            f"{turns_text(t)}")
    return res


# ---------------------------------------------------------------------------
# phase 18: the fixed-state sketches (HLL, count-min, the min-hash triangle sample)

SK_EMIT_BATCHES = 8  # (a): an emission every 8 batches of phase 7's replay
SK_HLL_EPS = 0.01  # (a): m = 2^16, the cap
SK_CM = (0.001, 0.01, 16)  # (a): eps, delta, top_k: d = 5, w = 4096
SK_TRI = (0.05, 0.05)  # (b): eps, delta: R = 4096, M = 8192
SK_TRI_EDGES = 1 << 20  # (b): drawn with repeats from phase 17 (e)'s ring, cut to SK_TRI_VERTICES
SK_TRI_VERTICES = 1 << 13  # 2^16 distinct edges: a 4096-row sample closes wedges from the first emission on
SK_TRI_BATCH = 1 << 16
SK_TRI_EMIT = 4  # (b): batches an emission
SK_REPS = 5
FMIX_OPS = 8  # integer operations of fmix32: three xor-shifts of two, two multiplies
HASH_OPS = FMIX_OPS + 1  # hash_u32: the salt's xor
PAIR_OPS = 2 * FMIX_OPS + 3  # hash_pair_u32: the salt's xor, hi's multiply, the xor
RANK_OPS = 5  # an HLL register's put: mask, shift, clz, subtract, compare


def np_fmix32(x):
    x = np.atleast_1d(np.asarray(x).astype(np.uint32))
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def np_hash_pair(lo, hi, salt: int):
    """hash_pair_u32 in numpy's wrapping u32 arithmetic, independent of the port."""
    golden = 0x9E3779B9
    h = np_fmix32(np.atleast_1d(np.asarray(lo).astype(np.uint32)) ^ np.uint32((salt * golden) & 0xFFFFFFFF))
    return np_fmix32(h ^ (np.atleast_1d(np.asarray(hi).astype(np.uint32)) * np.uint32(golden)))


def closures_oracle(elo, ehi, salt: int) -> tuple:
    """(the closed wedges // 2, the ordered pairs that share a vertex and
    whose other endpoints differ) of a sample, by numpy pair enumeration
    vertex by vertex: a pair closes where the member hash of its closing
    edge is a valid row's (not 0xFFFFFFFF)."""
    valid = elo != -1
    members = np.setdiff1d(np_hash_pair(elo[valid], ehi[valid], salt), [0xFFFFFFFF])
    rows = np.nonzero(valid)[0]
    inc = np.concatenate([np.stack([elo[rows], rows, ehi[rows]], 1), np.stack([ehi[rows], rows, elo[rows]], 1)])
    inc = inc[np.argsort(inc[:, 0], kind="stable")]
    cuts = np.flatnonzero(np.diff(inc[:, 0])) + 1
    closed = pairs = 0
    for grp in np.split(inc, cuts):
        if len(grp) < 2:
            continue
        r, o = grp[:, 1], grp[:, 2]
        i, j = np.meshgrid(np.arange(len(r)), np.arange(len(r)), indexing="ij")
        keep = (r[i] != r[j]) & (o[i] != o[j])
        a, b = o[i][keep], o[j][keep]
        pairs += len(a)
        closed += int(np.isin(np_hash_pair(np.minimum(a, b), np.maximum(a, b), salt), members).sum())
    return closed // 2, pairs


def bound_pair(nbytes: float, ops: float) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes at the
    HBM rate and the integer operations at the f32 rate."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (o, "operations") if o > b else (b, "bytes")


# phase 18 (b) with --parent-sketches-cu: e057c38's sketches.cu (tri_fold: a
# memset of its scratch, then the keys, hi and merge kernels; the closure
# count a block a strip of 32 rows against every row) with one part taken
# out, for the split of its time (the results are wrong; only their time
# counts); the form of FOLD_SPLIT
TRI_SPLIT = {
    "tri_fold: the keys kernel without its global merge of keys and registers": [
        ("        if (k < gkey[i]) atomicMin(gkey + i, k);", "        if (k == 1ull) atomicMin(gkey + i, k);"),
        ("    if (PRIVATE) merge_max(regs, sregs, m);", "    if (PRIVATE && m < 0) merge_max(regs, sregs, m);")],
    "tri_fold: the hi kernel removed": [
        ("        tri_hi_kernel<<<fold_blocks(d, n, false), THREADS, 0, stream>>>(gkey, ghi, rows, src, dst, mask, n);\n",
         "")],
    "tri_sampled_closures: the launch and the set build alone (no pair loop)": [
        ("    __syncthreads();\n    int count = 0;", "    __syncthreads();\n    if (rows > 0) return;\n    int count = 0;")],
    "tri_sampled_closures: the pair loop without set_has": [
        ("            count += key != EMPTY_HASH && set_has(set, tmask, key);", "            count += key != EMPTY_HASH;")],
}

# the current sketches.cu with one constant changed or one part taken out:
# the redesign's other shapes and the split of its time
TRI_DESIGNS = {
    "tri_fold: the launch and the init alone (the kernel returns at once)": [
        ("    int hb[TRI_HELD];\n", "    if (n >= 0) return;\n    int hb[TRI_HELD];\n")],
    "tri_fold: no hi step (the offers removed)": [
        ("        if (hb[k] >= 0) tri_offer_hi(tri_keys, shi, hb[k], hk[k], hh[k]);",
         "        if (hb[k] >= 0 && n < 0) tri_offer_hi(tri_keys, shi, hb[k], hk[k], hh[k]);")],
    "tri_fold: 2 edges a thread before another cluster": [
        ("constexpr int TRI_EDGES_A_THREAD = 1;", "constexpr int TRI_EDGES_A_THREAD = 2;")],
    "tri_fold: 4 edges a thread before another cluster": [
        ("constexpr int TRI_EDGES_A_THREAD = 1;", "constexpr int TRI_EDGES_A_THREAD = 4;")],
    "tri_fold: 8 edges a thread before another cluster (one cluster at 2^16)": [
        ("constexpr int TRI_EDGES_A_THREAD = 1;", "constexpr int TRI_EDGES_A_THREAD = 8;")],
    "tri_fold: private registers at every batch": [
        ("constexpr int TRI_PRIVATE_EDGES = 16;", "constexpr int TRI_PRIVATE_EDGES = 0;")],
    "tri_fold: 16 edges held a thread (no edge read again at 2^21)": [
        ("constexpr int TRI_HELD = 8;", "constexpr int TRI_HELD = 16;")],
    "tri_fold: clusters of 16 (non-portable)": [
        ("constexpr int TRI_CLUSTER = 8;", "constexpr int TRI_CLUSTER = 16;"),
        ("    cudaError_t err = allow(d, slot, kernel, smem);\n    if (err != cudaSuccess) return err;\n",
         "    cudaError_t err = allow(d, slot, kernel, smem);\n    if (err != cudaSuccess) return err;\n"
         "    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) != "
         "cudaSuccess)\n        return err;\n")],
    "tri_sampled_closures: the launch alone (the kernel returns at once)": [
        ("    extern __shared__ __align__(16) uint32_t closure_smem[];\n",
         "    extern __shared__ __align__(16) uint32_t closure_smem[];\n    if (rows > 0) return;\n")],
    "tri_sampled_closures: the build, the sync and the copies alone (no pair tested)": [
        ("    uint32_t count = 0;\n    if (q < qend) {", "    uint32_t count = 0;\n    if (q < qend && rows < 0) {")],
    "tri_sampled_closures: a block a 256 pairs": [
        ("constexpr uint32_t CLOSURE_PAIRS_A_BLOCK = 1024;", "constexpr uint32_t CLOSURE_PAIRS_A_BLOCK = 256;")],
    "tri_sampled_closures: a block a 16,384 pairs": [
        ("constexpr uint32_t CLOSURE_PAIRS_A_BLOCK = 1024;", "constexpr uint32_t CLOSURE_PAIRS_A_BLOCK = 16384;")],
}

# the triangle sketch's C entry points as e057c38 had them (TRI_SPLIT's
# variants too): tri_fold_launch (eh, elo, ehi, rows, regs, m, src, dst,
# mask, n, scratch, scratch bytes, stream) with its scratch's bytes, and
# tri_closures_launch (elo, ehi, rows, out, counter, stream); the current
# ones (TRI_DESIGNS) give the closure count a kept scratch of its own
PARENT_SKETCH_SIGNATURES = {"tri_fold_scratch_bytes": [_I],
                            "tri_fold_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P, _L, _P],
                            "tri_closures_launch": [_P, _P, _I, _P, _P, _P]}
SKETCH_SIGNATURES = {"tri_fold_scratch_bytes": [_I], "tri_closures_scratch_bytes": [_I],
                     "tri_fold_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P, _L, _P],
                     "tri_closures_launch": [_P, _P, _I, _P, _P, _L, _P]}


def sketch_variant_sources(parent_cu: str) -> dict:
    """{label: source path}: TRI_SPLIT over ``parent_cu`` (labels led by
    "e057c38") and TRI_DESIGNS over the current sketches.cu, written under
    the port's build directory."""
    from gelly_streaming_tpu_torch.ops import _cuda

    paths = {f"e057c38 {k}": v for k, v in split_sources(parent_cu, TRI_SPLIT, "sketches_parent").items()}
    paths.update(split_sources(str(_cuda.CSRC_DIR / "sketches.cu"), TRI_DESIGNS, "sketches_design"))
    return paths


def build_variants(paths: dict) -> tuple:
    """({label: path} of the variants that built, [the failures' first error
    lines]): all at once, then one by one where any failed."""
    from gelly_streaming_tpu_torch.ops import _cuda

    try:
        _cuda.build_all(list(paths.values()))
        return dict(paths), []
    except RuntimeError:
        pass
    built, failed = {}, []
    for label, path in paths.items():
        try:
            _cuda.build_all([path])
            built[label] = path
        except RuntimeError as e:
            first = next((ln for ln in str(e).splitlines() if "error" in ln), str(e).splitlines()[0])
            failed.append(f"{label}: {first.strip()}")
    return built, failed


def tri_calls(lib, parent: bool):
    """(fold(state, src, dst, n=None), closures(elo, ehi) -> int32 [1]) over
    ``lib``'s C entry points: e057c38's interface where ``parent`` (the
    counter in the output's second word), else the current one (the
    closure count's scratch kept here, zeroed once); ``n`` overrides the
    edge count (0: the call with no edge)."""
    import torch
    from gelly_streaming_tpu_torch.ops import _cuda

    bufs = {}
    tag = "e057c38" if parent else "variant"

    def stream(t):
        return torch.cuda.current_stream(t.device).cuda_stream

    def scratch(kind, rows, dev):
        if (kind, rows) not in bufs:
            nbytes = int((lib.tri_fold_scratch_bytes if kind == "fold" else lib.tri_closures_scratch_bytes)(rows))
            bufs[kind, rows] = torch.zeros((nbytes,), dtype=torch.uint8, device=dev)
        return bufs[kind, rows]

    def fold(st, s, d, n=None):
        rows = st.eh.shape[0]
        buf = scratch("fold", rows, s.device)
        _cuda.check(lib.tri_fold_launch(st.eh.data_ptr(), st.elo.data_ptr(), st.ehi.data_ptr(), rows,
                                        st.regs.data_ptr(), st.regs.shape[0], s.data_ptr(), d.data_ptr(), None,
                                        s.shape[0] if n is None else n, buf.data_ptr(), buf.numel(), stream(s)),
                    f"{tag} tri_fold_launch")

    def closures(elo, ehi):
        rows = elo.shape[0]
        if parent:
            out = torch.empty((2,), dtype=torch.int32, device=elo.device)
            _cuda.check(lib.tri_closures_launch(elo.data_ptr(), ehi.data_ptr(), rows, out.data_ptr(),
                                                out[1:].data_ptr(), stream(elo)), f"{tag} tri_closures_launch")
            return out[:1]
        out = torch.empty((1,), dtype=torch.int32, device=elo.device)
        buf = scratch("closures", rows, elo.device)
        _cuda.check(lib.tri_closures_launch(elo.data_ptr(), ehi.data_ptr(), rows, out.data_ptr(), buf.data_ptr(),
                                            buf.numel(), stream(elo)), f"{tag} tri_closures_launch")
        return out

    return fold, closures


def tri_turns(cpm, folds: dict, samples: dict, parent_lib, variants: dict) -> dict:
    """Phase 18 (b)'s in-turn timing, device ms on the held stream, each
    call on its own copy of its input: for each fold case {label: (state
    before, (src, dst))} and each closure case {label: (elo, ehi)}, the
    current kernel and e057c38's in turns (parent, current, current,
    parent), their outputs held equal first; then each variant ({label:
    library}; a label naming tri_fold before its colon times the fold,
    tri_sampled_closures the count) and e057c38's fold with no edge."""
    from gelly_streaming_tpu_torch.core.aggregation import clone_state
    from gelly_streaming_tpu_torch.ops import sketches as sko

    p_fold, p_clos = tri_calls(parent_lib, parent=True)

    def c_fold(st, s, d):
        sko.tri_fold(st.eh, st.elo, st.ehi, s, d, None, st.regs)

    def c_clos(elo, ehi):
        return sko.tri_sampled_closures(elo, ehi)

    calls = {label: tri_calls(lib, parent=label.startswith("e057c38")) for label, lib in variants.items()}
    out = {"tri_fold": {}, "tri_sampled_closures": {}}
    for case, (before, (s, d)) in folds.items():
        a, b = clone_state(before), clone_state(before)
        c_fold(a, s, d)
        p_fold(b, s, d)
        if tensor_err(tuple(a), tuple(b)):
            raise RuntimeError(f"phase 18 turns, {case}: e057c38's tri_fold and the current one differ")

        def measure(fn, before=before, s=s, d=d):
            return copies_device_ms(lambda cp: fn(cp, s, d), lambda: clone_state(before), SK_REPS, cpm)[0]

        row = measured_in_turns(measure, p_fold, c_fold)
        row["variants"] = {"e057c38 tri_fold: the call with n = 0 (the memset and the merge alone)":
                           measure(lambda st, s_, d_: p_fold(st, s_, d_, n=0))}
        for label, (v_fold, _) in calls.items():
            if "tri_fold" in label.split(":")[0]:
                row["variants"][label] = measure(v_fold)
        out["tri_fold"][case] = row
    for case, (elo, ehi) in samples.items():
        got, want = int(c_clos(elo, ehi)), int(p_clos(elo, ehi)[0])
        if got != want:
            raise RuntimeError(f"phase 18 turns, {case}: e057c38's closure count {want}, the current one {got}")

        def measure(fn, elo=elo, ehi=ehi):
            return copies_device_ms(lambda cp: fn(*cp), lambda: (elo, ehi), SK_REPS, cpm)[0]

        row = measured_in_turns(measure, p_clos, c_clos)
        row["count"] = got
        row["variants"] = {label: measure(v_clos) for label, (_, v_clos) in calls.items()
                           if "tri_sampled_closures" in label.split(":")[0]}
        out["tri_sampled_closures"][case] = row
    return out


def star_sample(rows: int, dev):
    """A sample whose every row is on vertex 0: (0, 1), ..., (0, rows), one
    group of ``rows`` incidences (rows (rows - 1) / 2 unordered pairs)."""
    import torch

    elo = torch.zeros((rows,), dtype=torch.int32, device=dev)
    return elo, torch.arange(1, rows + 1, dtype=torch.int32, device=dev)


def graph_nodes(fn) -> dict:
    """{kernel name (mangled, as libcuda names it), or "memset", "memcpy"
    or another node type: nodes} of one call of ``fn`` captured into a CUDA
    graph, which is never replayed (the call changes nothing): every
    launch and every memset the call enqueues is a node.  ``fn`` runs once
    before, so that its scratch and cached launch settings exist."""
    import ctypes
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    out = {}
    for node in nodes[:n.value]:
        kind = ctypes.c_int()
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        key = {1: "memcpy", 2: "memset"}.get(kind.value, f"node type {kind.value}")
        if kind.value == 0:  # a kernel: CUDA_KERNEL_NODE_PARAMS_v2 leads with its function
            params, name = (ctypes.c_void_p * 16)(), ctypes.c_char_p()
            if (cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params) != 0
                    or cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params[0])) != 0):
                raise RuntimeError("a kernel node's function has no name")
            key = name.value.decode()
        out[key] = out.get(key, 0) + 1
    graph.reset()
    return out


def launches_a_call(fn, reps: int = 4) -> dict:
    """What one call of ``fn`` enqueues, read twice: "graph", its nodes
    captured into a CUDA graph (``graph_nodes``); "runtime", the runtime's
    launch, memset and copy calls a call that torch.profiler records over
    ``reps`` calls.  "device" holds the profiler's device rows (launches a
    call): late in the whole smoke it records the runtime's calls but no
    device row, so no check reads it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {"graph": graph_nodes(fn)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    out["runtime"] = {e.key: e.count / reps for e in rows
                      if e.key.startswith(("cudaLaunch", "cudaMemset", "cudaMemcpy"))}
    out["device"] = {e.key: e.count / reps for e in rows
                     if (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0))}
    return out


def one_launch(reading: dict, kernel: str) -> bool:
    """A ``launches_a_call`` reading of one launch of ``kernel`` a call:
    one kernel node, no memset or copy node, and one runtime launch call
    and no memset or copy call a call."""
    nodes, calls = list(reading["graph"].items()), list(reading["runtime"].items())
    return (len(nodes) == 1 and kernel in nodes[0][0] and nodes[0][1] == 1
            and len(calls) == 1 and calls[0][0].startswith("cudaLaunch") and calls[0][1] == 1)


def hll_card_gap(banks) -> tuple:
    """(the largest |card - CPU| of ``hll_estimate`` over the register
    banks, its share of the stated tolerance): the card's f32 ``logf``
    against the CPU's on the same registers, held within
    ``hll_linear_tolerance(m)`` on the linear count and rtol 1e-6 on the
    raw estimate."""
    import torch
    from gelly_streaming_tpu_torch.summaries import sketches as sk

    gap = share = 0.0
    for regs in banks:
        m = regs.shape[0]
        host = regs.cpu()
        card, cpu = float(sk.hll_estimate(regs)), float(sk.hll_estimate(host))
        zeros = int((host == 0).sum())
        raw = sk.hll_alpha(m) * m * m / float(torch.exp2(-host.double()).sum())
        tol = sk.hll_linear_tolerance(m) if zeros and raw <= 2.5 * m else 1e-6 * abs(cpu)
        gap = max(gap, abs(card - cpu))
        share = max(share, abs(card - cpu) / tol)
    return gap, share


def phase_sketches(dev, cpm, data: dict, parent=None, variants=None) -> dict:
    """Phase 18: (a) ``HLLDegreeSummary(eps=0.01)`` and
    ``CountMinHeavyHitters(eps=0.001, delta=0.01, top_k=16)`` over phase
    7's EF40 replay, an emission every 8 batches; (b) ``phase_tri_sketch``
    (``parent`` and ``variants`` go there); (c) the reference's three
    accuracy contracts at its own shapes.  Every batch's state and every
    emission equal to the twins on the card; one C call a batch; times,
    bounds, library calls and idle shares for the report.  The HLL and
    count-min folds are timed on (a)'s first batch (cold registers) and
    its last."""
    import torch
    from gelly_streaming_tpu_torch.core.aggregation import clone_state
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.library import sketches as lsk
    from gelly_streaming_tpu_torch.ops import sketches as sko
    from gelly_streaming_tpu_torch.ops import wire_decode

    t_phase = time.perf_counter()
    res = {}
    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    bufs, width = data["bufs"], data["width"]
    cfg = StreamConfig(vertex_capacity=c, batch_size=batch, ingest_window_edges=SK_EMIT_BATCHES * batch)
    hagg, cagg = lsk.HLLDegreeSummary(eps=SK_HLL_EPS), lsk.CountMinHeavyHitters(*SK_CM)
    m, dd, ww = hagg.hll_m, cagg.depth, cagg.width

    def wire_run(agg, b):
        return EdgeStream.from_wire(b, batch, width, cfg, device=dev).aggregate(agg).collect()

    # (a) the main path, each descriptor alone, warmed on one buffer
    runs = {}
    for name, agg in (("hll", hagg), ("cm", cagg)):
        wire_run(agg, bufs[:1])
        sko.reset_launches()
        wire_decode.reset_launches()
        recs, secs = timed_run(lambda agg=agg: wire_run(agg, bufs))
        ef40_once_a_batch(f"phase 18 (a) {name}", nb)
        want = {k: nb if k == ("hll_fold" if name == "hll" else "cm_fold") else 0 for k in sko.KERNELS}
        if sko.LAUNCHES != want or any(sko.TWIN_CALLS.values()):
            raise RuntimeError(f"(a) {name}: not one C call a batch: {sko.LAUNCHES}, twins {sko.TWIN_CALLS}")
        if len(recs) != nb // SK_EMIT_BATCHES + 1:
            raise RuntimeError(f"(a) {name}: {len(recs)} emissions")
        runs[name] = (recs, secs, dict(sko.LAUNCHES))
    # every batch's state against the twins, each kernel call held; every emission against the twin's
    hk, ck = hagg.initial_state(cfg, dev), cagg.initial_state(cfg, dev)
    ht, ct = clone_state(hk), clone_state(ck)
    err_h = err_c = 0.0
    hll_gap = (0.0, 0.0)
    emitted = 0
    busy = {"hll": 0.0, "cm": 0.0}
    twin_s = {"hll": 0.0, "cm": 0.0}
    for i, b in enumerate(bufs):
        s, d = wire.unpack_edges(torch.from_numpy(b).to(dev), batch, width)
        if i == 0:
            first = (clone_state(hk), clone_state(ck)), (s, d)
        if i == nb - 1:
            before, last = (clone_state(hk), clone_state(ck)), (s, d)
        busy["hll"] += held_ms(lambda: hagg.update(hk, s, d, None, None), cpm)
        busy["cm"] += held_ms(lambda: cagg.update(ck, s, d, None, None), cpm)
        t0 = time.perf_counter()
        sko.hll_degree_fold_plain(ht.verts, ht.edges, s, d, None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sko.cm_fold_plain(ct.grid, dd, ww, s, None, None)
        sko.cm_fold_plain(ct.grid, dd, ww, d, None, None)
        torch.cuda.synchronize()
        twin_s["hll"] += t1 - t0
        twin_s["cm"] += time.perf_counter() - t1
        err_h = max(err_h, tensor_err(tuple(hk), tuple(ht)))
        err_c = max(err_c, tensor_err(tuple(ck), tuple(ct)))
        if (i + 1) % SK_EMIT_BATCHES == 0 or i == nb - 1:
            err_h = max(err_h, tensor_err(runs["hll"][0][emitted], hagg.transform(ht)))
            hll_gap = max(hll_gap, hll_card_gap((ht.verts, ht.edges)), key=lambda g: g[1])
            err_c = max(err_c, tensor_err(runs["cm"][0][emitted], cagg.transform(ct)))
            emitted += 1
    if err_h or err_c:
        raise RuntimeError(f"(a): the folds or emissions differ from the twins on the card (hll {err_h}, cm {err_c})")
    if hll_gap[1] > 1:
        raise RuntimeError(f"(a): hll_estimate on the card is {hll_gap[0]} from the CPU's, past its stated tolerance")
    log(f"  (a) hll_estimate at each emission, the card's against the CPU's on the same registers: at most "
        f"{hll_gap[0]:.6g} apart, {hll_gap[1]:.4f} of the stated tolerance (linear count: hll_linear_tolerance(m); "
        f"raw: rtol 1e-6)")
    # the exact oracles (not asserted): distinct vertices and edges, degrees
    src, dst = data["src"], data["dst"]
    t0 = time.perf_counter()
    seen = np.zeros(c, bool)
    seen[src] = True
    seen[dst] = True
    exact_v = int(seen.sum())
    s_t, d_t = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    exact_e = int(torch.unique(torch.minimum(s_t, d_t).to(torch.int64) * c + torch.maximum(s_t, d_t)).numel())
    del s_t, d_t
    deg = np.bincount(src, minlength=c) + np.bincount(dst, minlength=c)
    oracle_s = time.perf_counter() - t0
    v_est, e_est = (float(x) for x in runs["hll"][0][-1])
    ids, est = (x.cpu().numpy() for x in runs["cm"][0][-1])
    true_top = set(np.argsort(deg, kind="stable")[-SK_CM[2]:].tolist())
    rel = {"distinct_vertices": (v_est - exact_v) / exact_v, "distinct_edges": (e_est - exact_e) / exact_e,
           "top_k_overcount": float(((est - deg[ids]) / np.maximum(deg[ids], 1)).max()),
           "top_k_true_found": len(true_top & set(ids.tolist()))}
    # the kernels on the last batch, each call on its own copy of the state before it
    (hb, cb), (s, d) = before, last
    n = int(s.shape[0])
    h_bound = bound_pair(n * 8 + 2 * 2 * m * 4, n * (2 * HASH_OPS + PAIR_OPS + 2 + 3 * RANK_OPS))
    c_bound = bound_pair(n * 8 + 2 * dd * ww * 4, n * 2 * dd * (HASH_OPS + 2))
    t_h = kernel_timing(cpm, lambda cp: sko.hll_degree_fold(cp.verts, cp.edges, s, d, None), lambda: clone_state(hb),
                        lambda cp: sko.hll_degree_fold_plain(cp.verts, cp.edges, s, d, None), h_bound[0], SK_REPS)
    t_c = kernel_timing(cpm, lambda cp: sko.cm_degree_fold(cp.grid, dd, ww, s, d, None), lambda: clone_state(cb),
                        lambda cp: (sko.cm_fold_plain(cp.grid, dd, ww, s, None, None),
                                    sko.cm_fold_plain(cp.grid, dd, ww, d, None, None)), c_bound[0], SK_REPS)
    (hb0, cb0), (s0, d0) = first
    t_h["batch0"] = kernel_timing(cpm, lambda cp: sko.hll_degree_fold(cp.verts, cp.edges, s0, d0, None),
                                  lambda: clone_state(hb0),
                                  lambda cp: sko.hll_degree_fold_plain(cp.verts, cp.edges, s0, d0, None), h_bound[0],
                                  SK_REPS)
    t_c["batch0"] = kernel_timing(cpm, lambda cp: sko.cm_degree_fold(cp.grid, dd, ww, s0, d0, None),
                                  lambda: clone_state(cb0),
                                  lambda cp: (sko.cm_fold_plain(cp.grid, dd, ww, s0, None, None),
                                              sko.cm_fold_plain(cp.grid, dd, ww, d0, None, None)), c_bound[0],
                                  SK_REPS)
    # the library calls on the same precomputed inputs: one scatter_reduce_ (amax) over both banks, one index_add_
    fam = [sko.hash_u32(s, sko.SALT_VERTEX_HLL), sko.hash_u32(d, sko.SALT_VERTEX_HLL),
           sko.hash_pair_u32(*sko.canonical_edge(s, d), sko.SALT_EDGE_HLL)]
    p = m.bit_length() - 1
    idx = torch.cat([f & (m - 1) for f in fam[:2]] + [(fam[2] & (m - 1)) + m])
    rank = torch.cat([(33 - p - torch.frexp((f >> p).double()).exponent).to(torch.int32) for f in fam])
    regs = torch.cat([hb.verts, hb.edges])
    lib_h = cuda_ms(lambda: regs.scatter_reduce_(0, idx, rank, "amax"), SK_REPS)
    if not torch.equal(regs, torch.cat(sko.hll_degree_fold_plain(hb.verts.clone(), hb.edges.clone(), s, d, None))):
        raise RuntimeError("(a): the scatter_reduce_ yardstick does not compute the fold")
    cols = torch.cat([r * ww + (sko.hash_u32(k, sko.SALT_CM_ROW + r) & (ww - 1)) for k in (s, d) for r in range(dd)])
    ones = torch.ones(cols.shape, dtype=torch.int32, device=dev)
    grid = cb.grid.clone()
    lib_c = cuda_ms(lambda: grid.index_add_(0, cols, ones), SK_REPS, warmup=0)
    del fam, idx, rank, cols, ones
    for name, t, bnd, lib, err, launch in (("hll", t_h, h_bound, lib_h, err_h, "hll_fold"),
                                           ("cm", t_c, c_bound, lib_c, err_c, "cm_fold")):
        recs, secs, launches = runs[name]
        res[name] = {**t, "launches": launches[launch], "err": err, "bound_by": bnd[1], "library_ms": lib,
                     "s": secs, "edges_per_s": nb * batch / secs, "twin_s": twin_s[name], "busy_ms": busy[name],
                     "idle_pct": 100 * (1 - busy[name] / (secs * 1e3)), "emissions": len(recs)}
    res["hll"]["rel_err"] = {k: rel[k] for k in ("distinct_vertices", "distinct_edges")}
    res["hll"]["card_cpu_gap"] = {"abs": hll_gap[0], "share_of_tolerance": hll_gap[1]}
    res["cm"]["rel_err"] = {k: rel[k] for k in ("top_k_overcount", "top_k_true_found")}
    for name, label, what in (("hll", f"HLLDegreeSummary(eps={SK_HLL_EPS}) (m {m})",
                               f"distinct vertices {v_est:.8g} (exact {exact_v}, rel err {rel['distinct_vertices']:+.3e}), "
                               f"distinct edges {e_est:.8g} (exact {exact_e}, {rel['distinct_edges']:+.3e})"),
                              ("cm", f"CountMinHeavyHitters{SK_CM} (d {dd}, w {ww})",
                               f"top-{SK_CM[2]} estimates {est.min()}-{est.max()} against degrees "
                               f"{deg[ids].min()}-{deg[ids].max()} (the most overcount {rel['top_k_overcount']:.4g}x a "
                               f"degree; {rel['top_k_true_found']} of the true top {SK_CM[2]} found)")):
        r = res[name]
        log(f"  (a) {label} over phase 7's replay ({nb} x {batch} edges, C {c}, EF40, an emission every "
            f"{SK_EMIT_BATCHES} batches): {r['s']:.4f} s end to end, {r['edges_per_s']:.6g} edges/s, "
            f"{r['emissions']} emissions; launches {r['launches']}; every batch's state and every emission equal to "
            f"the twin on the card (twin {r['twin_s']:.2f} s); the last batch: device {r['device_ms']:.5f} ms held, "
            f"events {r['ms']:.5f} ms, host {r['host_us']:.2f} us a call, twin {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}), {r['ratio']:.2f}x; library call {r['library_ms']:.5f} ms; "
            f"the calls {r['busy_ms']:.3f} ms of device time (each held) against the run's {r['s'] * 1e3:.1f} ms: idle "
            f"{r['idle_pct']:.2f}%")
        b0 = r["batch0"]
        log(f"      batch 0 (cold registers): device {b0['device_ms']:.5f} ms held ({b0['ratio']:.2f}x the bound), "
            f"events {b0['ms']:.5f} ms, host {b0['host_us']:.2f} us a call, twin {b0['plain_ms']:.3f} ms")
        log(f"      {what} (oracles {oracle_s:.1f} s; not asserted)")
    res.update(phase_tri_sketch(dev, cpm, data, parent, variants))
    res["contracts"] = sketch_contracts(dev)
    res["s"] = time.perf_counter() - t_phase
    log(f"  phase 18: {res['s']:.1f} s")
    return res


def phase_tri_sketch(dev, cpm, data: dict, parent=None, variants=None) -> dict:
    """Phase 18 (b): ``SketchTriangleCount(eps=0.05, delta=0.05)`` (R =
    4096, M = 8192) over edges drawn with repeats from phase 17 (e)'s
    Watts-Strogatz ring at 2^13 vertices, an emission every 4 batches.
    Every batch's sample and registers and every emission equal to the
    twins on the card, the closure counts to a numpy oracle and nonzero;
    one C call a batch and one an emission, each enqueuing one launch and
    no memset (``launches_a_call``).  ``tri_fold`` is timed on the last batch and on
    (a)'s last batch of 2^21 edges folded into the final sample,
    ``tri_sampled_closures`` on the final sample and on the star sample
    (held against the twin); given ``parent`` (e057c38's library), each in
    turns with it, with ``variants`` ({label: library}: TRI_SPLIT and
    TRI_DESIGNS) beside them."""
    import torch
    from gelly_streaming_tpu_torch.core.aggregation import clone_state
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library import sketches as lsk
    from gelly_streaming_tpu_torch.ops import sketches as sko
    from gelly_streaming_tpu_torch.summaries import sketches as sks

    res = {}
    rng_b = np.random.default_rng(5)
    ring_s, ring_d = watts_strogatz(SK_TRI_VERTICES, 16, 0.1, rng_b)
    pick = rng_b.integers(0, len(ring_s), SK_TRI_EDGES)
    ws_s, ws_d = ring_s[pick], ring_d[pick]
    nbt = SK_TRI_EDGES // SK_TRI_BATCH
    cfg_b = StreamConfig(vertex_capacity=SK_TRI_VERTICES, batch_size=SK_TRI_BATCH,
                         ingest_window_edges=SK_TRI_EMIT * SK_TRI_BATCH)
    tagg = lsk.SketchTriangleCount(*SK_TRI)
    stream = EdgeStream.from_arrays(ws_s, ws_d, cfg_b, device=dev)
    if not tagg._wire_eligible(stream):
        raise RuntimeError("(b): the triangle sketch must ride the wire path")
    EdgeStream.from_arrays(ws_s[:SK_TRI_BATCH], ws_d[:SK_TRI_BATCH], cfg_b, device=dev).aggregate(tagg).collect()
    sko.reset_launches()
    recs, secs_t = timed_run(lambda: stream.aggregate(tagg).collect())
    launches = dict(sko.LAUNCHES)
    want = {"hll_fold": 0, "cm_fold": 0, "tri_fold": nbt, "tri_sampled_closures": nbt // SK_TRI_EMIT}
    if launches != want or any(sko.TWIN_CALLS.values()) or len(recs) != nbt // SK_TRI_EMIT:
        raise RuntimeError(f"(b): not one C call a batch and one closure count an emission: {launches}, "
                           f"{len(recs)} emissions")
    tk = tagg.initial_state(cfg_b, dev)
    tt = clone_state(tk)
    err_t, busy_t, twin_t, closure_check = 0.0, 0.0, 0.0, []
    for i in range(nbt):
        s, d = (torch.from_numpy(a[i * SK_TRI_BATCH:(i + 1) * SK_TRI_BATCH]).to(dev) for a in (ws_s, ws_d))
        if i == nbt - 1:
            before_t, last_t = clone_state(tk), (s, d)
        busy_t += held_ms(lambda: tagg.update(tk, s, d, None, None), cpm)
        t0 = time.perf_counter()
        sko.tri_fold_plain(tt.eh, tt.elo, tt.ehi, s, d, None, tt.regs)
        torch.cuda.synchronize()
        twin_t += time.perf_counter() - t0
        err_t = max(err_t, tensor_err(tuple(tk), tuple(tt)))
        if (i + 1) % SK_TRI_EMIT == 0:
            rec = recs[(i + 1) // SK_TRI_EMIT - 1]
            twin_rec = sks.tri_estimate((tt.eh, tt.elo, tt.ehi), tt.regs,
                                        sko.tri_sampled_closures_plain(tt.elo, tt.ehi))
            err_t = max(err_t, tensor_err(rec, twin_rec))
            got = int(sko.tri_sampled_closures(tk.elo, tk.ehi))
            oracle, pairs = closures_oracle(tk.elo.cpu().numpy(), tk.ehi.cpu().numpy(), sko.SALT_MEMBER)
            closure_check.append((got, oracle, pairs))
            if got != oracle or not got:
                raise RuntimeError(f"(b): batch {i}'s closure count {got} differs from the numpy oracle's {oracle}, "
                                   "or the sample closes no wedge")
    if err_t:
        raise RuntimeError(f"(b): the sample or an emission differs from the twin on the card ({err_t})")
    exact_tri = triangle_oracle(ws_s, ws_d, SK_TRI_VERTICES)[1]
    est, occ, distinct = (float(x) for x in recs[-1])
    n = SK_TRI_BATCH
    rows, mt = tagg.rows, tagg.hll_m
    t_bound = bound_pair(n * 8 + rows * 16 * 2 + mt * 4 * 2, n * (3 + 3 * PAIR_OPS + PAIR_OPS + RANK_OPS + 4))
    t_t = kernel_timing(cpm, lambda cp: sko.tri_fold(cp.eh, cp.elo, cp.ehi, *last_t, None, cp.regs),
                        lambda: clone_state(before_t),
                        lambda cp: sko.tri_fold_plain(cp.eh, cp.elo, cp.ehi, *last_t, None, cp.regs), t_bound[0],
                        SK_REPS)
    valid = int((tk.elo != -1).sum())
    # (i, j) and (j, i) close alike: the work is each unordered sharing pair tested once
    c_bound = bound_pair(rows * 8 + 4, valid * PAIR_OPS + closure_check[-1][2] // 2 * (PAIR_OPS + 4))
    t_cl = kernel_timing(cpm, lambda cp: sko.tri_sampled_closures(*cp), lambda: (tk.elo, tk.ehi),
                         lambda cp: sko.tri_sampled_closures_plain(*cp), c_bound[0], SK_REPS)
    res["tri"] = {**t_t, "launches": launches["tri_fold"], "err": err_t, "bound_by": t_bound[1], "s": secs_t,
                  "edges_per_s": SK_TRI_EDGES / secs_t, "twin_s": twin_t, "busy_ms": busy_t,
                  "idle_pct": 100 * (1 - busy_t / (secs_t * 1e3)), "emissions": len(recs), "estimate": est,
                  "occupied": occ, "distinct_edges": distinct, "exact_triangles": exact_tri,
                  "rel_err": (est - exact_tri) / exact_tri if exact_tri else None}
    res["closures"] = {**t_cl, "launches": launches["tri_sampled_closures"], "err": err_t, "bound_by": c_bound[1],
                       "closures_oracle": [list(x) for x in closure_check], "valid_rows": valid}
    r, q = res["tri"], res["closures"]
    log(f"  (b) SketchTriangleCount{SK_TRI} (R {rows}, M {mt}) over {SK_TRI_EDGES} edges drawn with repeats from "
        f"phase 17 (e)'s Watts-Strogatz ring at C {SK_TRI_VERTICES} ({len(ring_s)} edges; batches of "
        f"{SK_TRI_BATCH}, an emission every {SK_TRI_EMIT}): "
        f"{secs_t:.4f} s end to end, {SK_TRI_EDGES / secs_t:.6g} edges/s; launches {launches}; every batch's sample "
        f"and registers and every emission equal to the twin on the card (twin {twin_t:.2f} s); estimate {est:.8g} "
        f"against scipy's {exact_tri} (rel err {r['rel_err']:+.3e}; not asserted), {occ:.0f} rows occupied, distinct "
        f"edges {distinct:.8g}")
    log(f"      tri_fold, the last batch: device {r['device_ms']:.5f} ms held, events {r['ms']:.5f} ms, host "
        f"{r['host_us']:.2f} us a call, twin {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
        f"{r['ratio']:.2f}x; the calls {busy_t:.3f} ms of device time (each held) against the run's "
        f"{secs_t * 1e3:.1f} ms: idle {r['idle_pct']:.2f}%")
    log(f"      tri_sampled_closures, the final sample ({valid} valid rows): device {q['device_ms']:.5f} ms held, "
        f"events {q['ms']:.5f} ms, host {q['host_us']:.2f} us a call, twin {q['plain_ms']:.3f} ms, bound "
        f"{q['bound_ms']:.6f} ms ({q['bound_by']}), {q['ratio']:.1f}x; (count, numpy oracle, sharing pairs) at each "
        f"emission {closure_check}")

    # (a)'s last batch of 2^21 edges folded into the final sample, and the star sample (one group of R rows)
    s_w, d_w = (torch.from_numpy(np.ascontiguousarray(a[-CC_BATCH:])).to(dev) for a in (data["src"], data["dst"]))
    a_w, b_w = clone_state(tk), clone_state(tk)
    sko.tri_fold(a_w.eh, a_w.elo, a_w.ehi, s_w, d_w, None, a_w.regs)
    sko.tri_fold_plain(b_w.eh, b_w.elo, b_w.ehi, s_w, d_w, None, b_w.regs)
    nw = int(s_w.shape[0])
    w_bound = bound_pair(nw * 8 + rows * 16 * 2 + mt * 4 * 2, nw * (3 + 3 * PAIR_OPS + PAIR_OPS + RANK_OPS + 4))
    wide = kernel_timing(cpm, lambda cp: sko.tri_fold(cp.eh, cp.elo, cp.ehi, s_w, d_w, None, cp.regs),
                         lambda: clone_state(tk),
                         lambda cp: sko.tri_fold_plain(cp.eh, cp.elo, cp.ehi, s_w, d_w, None, cp.regs), w_bound[0],
                         SK_REPS)
    wide.update(err=tensor_err(tuple(a_w), tuple(b_w)), edges=nw, bound_by=w_bound[1])
    star = star_sample(rows, dev)
    star_n = int(sko.tri_sampled_closures(*star))
    star_pairs = rows * (rows - 1) // 2
    s_bound = bound_pair(rows * 8 + 4, rows * PAIR_OPS + star_pairs * (PAIR_OPS + 4))
    star_t = kernel_timing(cpm, lambda cp: sko.tri_sampled_closures(*cp), lambda: star,
                           lambda cp: sko.tri_sampled_closures_plain(*cp), s_bound[0], SK_REPS)
    star_t.update(count=star_n, err=abs(star_n - int(sko.tri_sampled_closures_plain(*star))), pairs=star_pairs,
                  bound_by=s_bound[1])
    if wide["err"] or star_t["err"]:
        raise RuntimeError(f"(b): the 2^21-edge fold ({wide['err']}) or the star's count ({star_t['err']}) differs "
                           "from the twin on the card")
    r["wide"], q["star"] = wide, star_t
    cp_t = clone_state(before_t)  # folding one batch again leaves the state as it is
    r["launches_a_call"] = launches_a_call(lambda: sko.tri_fold(cp_t.eh, cp_t.elo, cp_t.ehi, *last_t, None, cp_t.regs))
    q["launches_a_call"] = launches_a_call(lambda: sko.tri_sampled_closures(tk.elo, tk.ehi))
    log(f"      tri_fold, (a)'s last batch ({nw} edges over C {CC_VERTICES}) into the final sample: device "
        f"{wide['device_ms']:.5f} ms held, events {wide['ms']:.5f} ms, host {wide['host_us']:.2f} us a call, twin "
        f"{wide['plain_ms']:.3f} ms, bound {wide['bound_ms']:.6f} ms ({wide['bound_by']}), {wide['ratio']:.2f}x; "
        "equal to the twin")
    log(f"      tri_sampled_closures, the star sample ({rows} rows on vertex 0, {star_pairs} unordered pairs): count "
        f"{star_n} (the twin's too), device {star_t['device_ms']:.5f} ms held, events {star_t['ms']:.5f} ms, twin "
        f"{star_t['plain_ms']:.3f} ms, bound {star_t['bound_ms']:.6f} ms ({star_t['bound_by']}), "
        f"{star_t['ratio']:.1f}x")
    log(f"      a call enqueues (CUDA graph nodes; torch.profiler's runtime calls and device rows): tri_fold "
        f"{r['launches_a_call']}, tri_sampled_closures {q['launches_a_call']}")
    if not (one_launch(r["launches_a_call"], "tri_cluster_kernel")
            and one_launch(q["launches_a_call"], "closures_kernel")):
        raise RuntimeError("(b): tri_fold or tri_sampled_closures does not enqueue one launch and no memset a call")
    if parent is not None:
        turns = tri_turns(cpm, {"(b)'s last batch": (before_t, last_t), "(a)'s last batch of 2^21 edges": (tk, (s_w, d_w))},
                          {"(b)'s final sample": (tk.elo, tk.ehi), "the star sample": star}, parent, variants or {})
        for kernel, key in (("tri_fold", "tri"), ("tri_sampled_closures", "closures")):
            for case, row in turns[kernel].items():
                res[key].setdefault("turns", {})[case] = row
                log(f"      {kernel}, {case}, e057c38 in turns (device ms held): {turns_text(row)}")
                for label, ms in row["variants"].items():
                    log(f"        {label}: {ms:.5f} ms")
    return res


def sketch_contracts(dev) -> dict:
    """Phase 18 (c): the reference's accuracy contracts at its own shapes
    (tests/test_sketches.py:113-170), asserted as it asserts them, and the
    dense sample's closures against the numpy oracle."""
    import torch
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library import sketches as lsk
    from gelly_streaming_tpu_torch.ops import sketches as sko

    def skewed(n_, cap, seed):
        rng = np.random.default_rng(seed)
        comm = max(cap >> 14, 64)
        cbase = ((cap * rng.random(n_) ** 2).astype(np.int64) // comm) * comm
        s_ = cbase + (comm * rng.random(n_) ** 2).astype(np.int64)
        d_ = cbase + (comm * rng.random(n_) ** 4).astype(np.int64)
        return (s_ % cap).astype(np.int32), (d_ % cap).astype(np.int32)

    def one_run(agg, s_, d_, cap, b):
        cfg_c = StreamConfig(vertex_capacity=cap, batch_size=b, ingest_window_edges=len(s_))
        return EdgeStream.from_arrays(s_, d_, cfg_c, device=dev).aggregate(agg).collect()[-1]

    rng = np.random.default_rng(5)
    s_, d_ = rng.integers(0, 4096, 20_000).astype(np.int32), rng.integers(0, 4096, 20_000).astype(np.int32)
    agg = lsk.HLLDegreeSummary(eps=0.05, delta=0.05)
    v, e = (float(x) for x in one_run(agg, s_, d_, 4096, 2048))
    ev = len(np.unique(np.concatenate([s_, d_])))
    ee = len(np.unique(np.minimum(s_, d_).astype(np.int64) * 4096 + np.maximum(s_, d_)))
    contract = {"hll": (abs(v - ev) / ev, abs(e - ee) / ee)}
    if not (contract["hll"][0] < agg.eps and contract["hll"][1] < agg.eps):
        raise RuntimeError(f"(c): HLLDegreeSummary outside its contract: {contract['hll']}")
    s_, d_ = skewed(20_000, 512, 9)
    agg = lsk.CountMinHeavyHitters(eps=0.01, delta=0.02, top_k=16)
    ids, est_c = (x.cpu().numpy() for x in one_run(agg, s_, d_, 512, 2048))
    deg_c = np.bincount(s_, minlength=512) + np.bincount(d_, minlength=512)
    contract["cm"] = int((est_c - deg_c[ids]).max())
    if not (np.all(est_c >= deg_c[ids]) and np.all(est_c - deg_c[ids] <= agg.eps * 2 * 20_000)
            and set(np.argsort(deg_c)[-8:].tolist()) <= set(ids.tolist())):
        raise RuntimeError("(c): CountMinHeavyHitters outside its contract")
    s_, d_ = skewed(40 << 10, 256, 7)
    agg = lsk.SketchTriangleCount(eps=0.05, delta=0.05)
    est_t = float(one_run(agg, s_, d_, 256, 1 << 12)[0])
    adj = np.zeros((256, 256), dtype=np.int64)
    keep = s_ != d_
    adj[s_[keep], d_[keep]] = 1
    adj = np.maximum(adj, adj.T)
    exact_c = int(np.trace(adj @ adj @ adj)) // 6
    contract["tri"] = abs(est_t - exact_c) / exact_c
    if not (exact_c > 0 and contract["tri"] < agg.eps):
        raise RuntimeError(f"(c): SketchTriangleCount outside its contract: {contract['tri']}")
    # the same sample in one C call (the fold is order-free): its closures against the numpy oracle
    st = agg.initial_state(StreamConfig(vertex_capacity=256), dev)
    agg.update(st, torch.from_numpy(s_).to(dev), torch.from_numpy(d_).to(dev), None, None)
    closed = int(sko.tri_sampled_closures(st.elo, st.ehi))
    contract["tri_closures"] = (closed, *closures_oracle(st.elo.cpu().numpy(), st.ehi.cpu().numpy(), sko.SALT_MEMBER))
    if closed != contract["tri_closures"][1] or not closed or float(agg.transform(st)[0]) != est_t:
        raise RuntimeError(f"(c): the dense sample's closures {contract['tri_closures']} (count, oracle, pairs) or "
                           "estimate differ")
    log(f"  (c) the reference's contracts on the card: HLL rel errs {contract['hll'][0]:.3e} / "
        f"{contract['hll'][1]:.3e} (< 0.05), count-min the most overcount {contract['cm']} (<= {0.01 * 2 * 20_000:g}, "
        f"never under, the true top 8 found), triangles {est_t:.8g} against {exact_c} (rel err {contract['tri']:.3e} "
        f"< 0.05; the sample's closures {closed} equal to the numpy oracle over {contract['tri_closures'][2]} "
        f"sharing pairs): all held")
    return contract


# ---------------------------------------------------------------------------
# phase 19: checkpoints, supervised recovery and the compressed ingest

CK_EVERY = 8  # (a): wire_checkpoint_batches
CK_GROUP = 8  # (a), (b): superbatch, so that the ingest pool packs a group's batches in parallel
CK_CRASH_CALL = 27  # (a): the crashing descriptor's update raises on this call
CK_PAIRS = 3  # (a): (snapshots, none) runs timed in turns
BDV_RANDOM_BUFFERS = 4096  # (c)


def bdv_cases(rng) -> list:
    """(label, [(uint8 buffer, n, valued), ...]) that bdv_decode must decode
    bit for bit as its twin: a group arena's rows (each read with the arena's
    width), varints at the 1/2/3/4-byte boundaries, ids up to 2^28 - 1, the
    valued layout, n in {0, 1, 3, 5}, bucket padding, a truncated buffer
    and random bytes (clipped reads)."""
    from gelly_streaming_tpu_torch.io import wire

    def pack(n, cap, valued=False, seed=0):
        r = np.random.default_rng(seed)
        s, d = r.integers(0, cap, n).astype(np.int32), r.integers(0, cap, n).astype(np.int32)
        v = r.integers(-(1 << 27), 1 << 27, n).astype(np.int32) if valued else None
        return wire.pack_edges_bdv(s, d, cap, val_i32=v)

    rows = [pack(n, 1 << 20, seed=n) for n in (4096, 4096, 4096, 4096)]
    rows[1] = pack(4096, 1 << 10, seed=1)  # narrower: mostly 1-byte deltas
    rows[3] = pack(4096, 1 << 28, seed=3)  # wider: 4-byte src deltas
    widest = max(r.nbytes for r in rows)
    arena = np.zeros((4, widest), np.uint8)
    for j, r in enumerate(rows):
        arena[j, : r.nbytes] = r
    bounds = np.array([0, 1, 255, 256, 65535, 65536, (1 << 24) - 1, 1 << 24, (1 << 29) - 1, 1 << 29], np.uint64)
    stream = np.concatenate([bounds, bounds[::-1]])
    varints = wire._varint_encode_np(stream)
    top = (1 << 28) - 1
    ids = np.array([top, 0, top, top - 1, 0, top], np.int32)
    full = pack(1 << 16, 1 << 20, seed=7)
    cases = [
        ("group arena rows", [(arena[j], 4096, False) for j in range(4)]),
        ("varint boundaries", [(varints, len(stream) // 2, False), (varints, len(stream) // 3, True)]),
        ("ids to 2^28 - 1", [(wire.pack_edges_bdv(ids, ids[::-1].copy(), 1 << 28), 6, False)]),
        ("valued", [(pack(n, 1 << 20, True, n), n, True) for n in (1, 3, 5, 4097, 70001)]),
        ("n in {0, 1, 3, 5}", [(pack(max(n, 1), 1 << 20, seed=n), n, v) for n in (0, 1, 3, 5) for v in (False, True)]),
        ("bucket padding", [(np.concatenate([pack(n, 1 << 16, seed=n), np.zeros(n, np.uint8)]), n, False)
                            for n in (2047, 2048, 2049)]),
        ("truncated", [(full[: full.nbytes // 2], 1 << 16, False), (full[:3], 1 << 16, False)]),
        ("random bytes", [(rng.integers(0, 256, int(nb)).astype(np.uint8), int(n), bool(v))
                          for nb, n, v in zip(rng.integers(1, 1 << 12, BDV_RANDOM_BUFFERS),
                                              rng.integers(1, 1 << 11, BDV_RANDOM_BUFFERS),
                                              rng.integers(0, 2, BDV_RANDOM_BUFFERS))]),
    ]
    return cases


EF40_RANDOM_BUFFERS = 512  # (c)


def ef40_cases(rng, data: dict) -> list:
    """(label, [(uint8 buffer, n, capacity, offset), ...]) that ef40_unpack
    must unpack bit for bit as its twin: packed batches (n from 1 to 2^21,
    C up to 2^20, odd n), bitvectors with no, every, too few and too many
    ones, random bytes, and views that start at every offset of a 16-byte
    word (``offset``: the view's first byte in a larger buffer)."""
    from gelly_streaming_tpu_torch.io import wire

    def packed(n, cap):
        s, d = rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)
        return wire.pack_edges(s, d, (wire.EF40, cap))

    def arbitrary(n, cap, density=None):
        buf = rng.integers(0, 256, wire.ef40_nbytes(n, cap)).astype(np.uint8)
        bv = (n + cap + 7) // 8
        if density is not None:
            buf[:bv] = np.packbits(rng.random(8 * bv) < density, bitorder="little")
        return buf

    big = (1 << 21, 1 << 20)
    shapes = [(1, 1), (5, 2), (4097, 1000), (70001, 1 << 16), ((1 << 21) - 1, 1 << 20), big]
    mid = packed(12345, 4099)
    return [
        ("the CC batch", [(data["bufs"][-1], CC_BATCH, CC_VERTICES, 0)]),
        ("packed, n 1 to 2^21, odd n", [(packed(n, cap), n, cap, 0) for n, cap in shapes]),
        ("no ones", [(arbitrary(n, cap, 0.0), n, cap, 0) for n, cap in ((1, 1), (5000, 300), big)]),
        ("every one", [(arbitrary(n, cap, 1.0), n, cap, 0) for n, cap in ((1, 1), (5000, 300), big)]),
        ("too few ones", [(arbitrary(n, cap, n / (4 * (n + cap))), n, cap, 0) for n, cap in ((9, 40), big)]),
        ("too many ones", [(arbitrary(n, cap, min(1.0, 2 * n / (n + cap))), n, cap, 0) for n, cap in ((9, 40), big)]),
        ("C = 0", [(arbitrary(n, 0), n, 0, 0) for n in (1, 5, 4096)]),
        ("views at offsets 1-15", [(mid, 12345, 4099, off) for off in range(1, 16)]),
        ("random bytes", [(arbitrary(int(n), int(cap)), int(n), int(cap), 0)
                          for n, cap in zip(rng.integers(1, 1 << 12, EF40_RANDOM_BUFFERS),
                                            rng.integers(0, 1 << 12, EF40_RANDOM_BUFFERS))]),
    ]


def ef40_check_cases(dev, cases) -> tuple:
    """Every case through ef40_unpack and its twin on the card: (buffers,
    mismatching buffers); one launch a buffer."""
    import torch

    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    checked = bad = 0
    for label, items in cases:
        for buf, n, cap, off in items:
            host = torch.from_numpy(np.ascontiguousarray(buf))
            room = torch.zeros((off + host.numel(),), dtype=torch.uint8, device=dev)
            b = room[off:]
            b.copy_(host)
            before = wd.LAUNCHES["ef40_unpack"]
            got = wd.unpack_edges_ef40(b, n, cap)
            launched = wd.LAUNCHES["ef40_unpack"] - before
            want = wd.unpack_edges_ef40_plain(b, n, cap)
            checked += 1
            if launched != 1 or not all(g.dtype == torch.int32 and torch.equal(g, w) for g, w in zip(got, want)):
                bad += 1
                log(f"  ef40_unpack differs from its twin: {label}, n {n}, C {cap}, offset {off} ({launched} launches)")
    return checked, bad


def bdv_payload_nbytes(buf, n: int, valued: bool = False) -> int:
    """The bytes of a BDV buffer that a decode of ``n`` edges reads: the
    control block and the varints its 2-bit lengths cover (the bucket's
    zero padding past them is never read)."""
    count = (3 if valued else 2) * n
    ctrl = (count + 3) // 4
    codes = (np.asarray(buf[:ctrl], np.uint8)[:, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3
    return ctrl + int(codes.reshape(-1)[:count].astype(np.int64).sum()) + count


def bdv_check_cases(dev, cases) -> tuple:
    """Every case through bdv_decode and its twin on the card: (buffers,
    mismatching buffers)."""
    import torch

    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    checked = bad = 0
    for label, items in cases:
        for buf, n, valued in items:
            b = torch.from_numpy(np.ascontiguousarray(buf)).to(dev)
            got = wd.decode_bdv(b, n, valued)
            want = wd.decode_bdv_plain(b, n, valued)
            ok = len(got) == len(want) and all(g.dtype == torch.int32 and torch.equal(g, w)
                                               for g, w in zip(got, want))
            checked += 1
            if not ok:
                bad += 1
                log(f"  bdv_decode differs from its twin: {label}, n {n}, valued {valued}, {buf.nbytes} B")
    return checked, bad


# bdv_decode as 5985037 had it (one launch after a memset of the look-back
# header, two chained decoupled look-backs) with one part taken out, for the
# split of its time (phase 19 (b)); the form of BACKWARD_SPLIT.  The outputs
# are wrong; only their time counts.
_BDV_DELTA_LOOKBACK = [
    ("    const uint2 p = look_back<uint2>(tile, tile_sums, make_uint2(0u, 0u), st.delta_flags, st.delta_aggs,\n"
     "                                     st.delta_incls);\n", "    const uint2 p = make_uint2(0u, 0u);\n")]
_BDV_BYTE_LOOKBACK = [
    ("    const long long p = look_back<long long>(tile, tile_bytes, 0, st.byte_flags, st.byte_aggs, st.byte_incls);",
     "    const long long p = static_cast<long long>(tile) * tile_bytes;")]
_BDV_STAGING = [("    bytes[i] = __ldg(buf + (at < nb ? at : nb - 1));\n", "    if (nb < 0) bytes[i] = 0;\n")]
BDV_SPLIT = {
    "the launch alone (the memset, then a kernel that returns at once)": [
        ("  if (threadIdx.x == 0) tile_s = atomicAdd(st.ticket, 1);\n",
         "  if (n >= 0) return;\n  if (threadIdx.x == 0) tile_s = atomicAdd(st.ticket, 1);\n")],
    "the delta look-back (a zero prefix)": _BDV_DELTA_LOOKBACK,
    "both look-backs (a tile's byte offset guessed as its index times its own bytes, a zero delta prefix)":
        _BDV_DELTA_LOOKBACK + _BDV_BYTE_LOOKBACK,
    "the staging (the decode reads shared memory never written)": _BDV_STAGING,
    "both look-backs and the staging": _BDV_DELTA_LOOKBACK + _BDV_BYTE_LOOKBACK + _BDV_STAGING,
}
# The current bdv_decode with one part taken out, for the split of its time
# (phase 19 (b), beside BDV_SPLIT); the same form, the outputs wrong.
_BDV_SECOND_SYNC = ("      if (kPer == 3) row[2 * kCol + q] = vals[q];\n    }\n    grid.sync();",
                    "      if (kPer == 3) row[2 * kCol + q] = vals[q];\n    }\n    __syncthreads();")
BDV_DESIGNS = {
    "the launch alone (a kernel that returns at once)": [
        ("  const bool aligned = (reinterpret_cast<uintptr_t>(buf) & 3) == 0;\n",
         "  if (n >= 0) return;\n  const bool aligned = (reinterpret_cast<uintptr_t>(buf) & 3) == 0;\n")],
    "the staging (the decode reads shared memory never written)": [
        ("    const int lead = stage(bytes, buf, nb, ctrl + byte_base + bytes_before, chunk_bytes, kThreads);",
         "    const int lead = nb < 0 ? stage(bytes, buf, nb, ctrl, chunk_bytes, kThreads) : 0;")],
    "the second grid sync (a block barrier)": [_BDV_SECOND_SYNC],
    "both grid syncs (block barriers)": [
        ("    if (threadIdx.x == 0) tot.bytes[b] = chunk_bytes;\n    grid.sync();",
         "    if (threadIdx.x == 0) tot.bytes[b] = chunk_bytes;\n    __syncthreads();"), _BDV_SECOND_SYNC],
    "the column writes (the edges' stores)": [
        ("      dst[c0 + i] = static_cast<int>(p.x + cols[at]);\n"
         "      src[c0 + i] = static_cast<int>(p.y + cols[kCol + at]);\n", "")],
}
# 5985037's wire_decode.cu entry points (the current ones keep them)
PARENT_WIRE_SIGNATURES = {"bdv_decode_scratch_bytes": [_I],
                          "bdv_decode_launch": [_P, _L, _I, _I, _P, _P, _P, _P, _L, _P]}


def bdv_call(lib):
    """decode(buf, n) -> (src, dst) over ``lib``'s ``bdv_decode_launch``
    (5985037's C interface), its outputs and scratch kept across calls."""
    import torch
    from gelly_streaming_tpu_torch.ops import _cuda

    kept = {}

    def decode(buf, n):
        if n not in kept:
            scratch = torch.empty((int(lib.bdv_decode_scratch_bytes(n)),), dtype=torch.uint8, device=buf.device)
            kept[n] = (torch.empty((n,), dtype=torch.int32, device=buf.device),
                       torch.empty((n,), dtype=torch.int32, device=buf.device), scratch)
        src, dst, scratch = kept[n]
        _cuda.check(lib.bdv_decode_launch(buf.data_ptr(), buf.numel(), n, 0, src.data_ptr(), dst.data_ptr(), None,
                                          scratch.data_ptr(), scratch.numel(),
                                          torch.cuda.current_stream(buf.device).cuda_stream), "bdv_decode_launch")
        return src, dst

    return decode


def bdv_turns(cpm, buf, n: int, parent_lib, variants: dict) -> dict:
    """Phase 19 (b)'s batch through 5985037's ``bdv_decode`` and the
    current one in turns (parent, current, current, parent; device ms on
    the held stream, 50 calls each), outputs held equal first; then each
    variant of ``variants`` ({label: library}: BDV_SPLIT over the parent,
    labels led by "5985037", and BDV_DESIGNS over the current source)
    beside a reading of its own source."""
    import torch
    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    parent = bdv_call(parent_lib)
    want = wd.decode_bdv(buf, n)
    if not all(torch.equal(g, w) for g, w in zip(parent(buf, n), want)):
        raise RuntimeError("5985037's bdv_decode and the current one differ on phase 19 (b)'s batch")

    def measure(fn):
        return device_ms(fn, 50, cpm)[0]

    out = measured_in_turns(measure, lambda: parent(buf, n), lambda: wd.decode_bdv(buf, n))
    log(f"  (b) bdv_decode in turns with 5985037's: {turns_text(out)}")
    split = {}
    for label, lib in variants.items():
        fn = bdv_call(lib)
        whole = parent if label.startswith("5985037") else (lambda b_, n_: wd.decode_bdv(b_, n_))
        split[label] = {"ms": measure(lambda: fn(buf, n)), "whole_ms": measure(lambda: whole(buf, n))}
        log(f"  (b) bdv_decode without {label}: {split[label]['ms']:.5f} ms (the whole kernel beside it "
            f"{split[label]['whole_ms']:.5f} ms)")
    out["split"] = split
    return out


def phase_checkpoints(dev, cpm, data: dict, parent=None, variants=None) -> dict:
    """Phase 19 on the CC bench's stream: (a) checkpointed CC under
    run_supervised with a crash, (b) the compressed and binned ingest (with
    ``parent``, 5985037's wire_decode.cu loaded, ``bdv_decode`` in turns
    with it and ``variants``, BDV_SPLIT over it, timed), (c) bdv_decode and
    ef40_unpack against their twins.  The snapshots go to a temporary
    directory, removed afterwards."""
    ck_dir = tempfile.mkdtemp(prefix="phase19-")
    try:
        return checkpoint_runs(dev, cpm, data, os.path.join(ck_dir, "cc"), parent, variants or {})
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)


def checkpoint_runs(dev, cpm, data: dict, path: str, parent=None, variants=None) -> dict:
    """phase_checkpoints' runs, their snapshot at ``path``."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import ingest, wire
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents
    from gelly_streaming_tpu_torch.ops import unionfind as uf
    from gelly_streaming_tpu_torch.ops import wire_decode as wd
    from gelly_streaming_tpu_torch.utils import checkpoint, metrics, native
    from gelly_streaming_tpu_torch.utils.recovery import run_supervised

    t_phase = time.perf_counter()
    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    src, dst = data["src"], data["dst"]
    n_edges = nb * batch
    if "oracle" not in data:
        data["oracle"] = cc_oracle(src, dst, c)
    o_parent, o_seen = data["oracle"]
    out = {}

    def labels_of(records):
        ds = records[-1][0]
        return ds.parent.cpu().numpy(), ds.seen.cpu().numpy()

    def check_labels(got, label):
        if not (np.array_equal(got[0], o_parent) and np.array_equal(got[1], o_seen)):
            raise RuntimeError(f"{label}: final labels differ from scipy's connected components")

    def timed_run(cfg, ckpt, k=nb):
        if os.path.exists(path + ".npz"):
            os.remove(path + ".npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = EdgeStream.from_arrays(src[: k * batch], dst[: k * batch], cfg, device=dev).aggregate(
            ConnectedComponents(), checkpoint_path=path if ckpt else None).collect()
        got = labels_of(recs)
        return time.perf_counter() - t0, got

    # (a) checkpointed streaming CC, one crash, run_supervised
    cfg = StreamConfig(vertex_capacity=c, batch_size=batch, wire_checkpoint_batches=CK_EVERY, superbatch=CK_GROUP)
    width = ConnectedComponents()._wire_width(cfg, batch)
    timed_run(cfg, True, 2 * CK_GROUP)  # warm the path: allocator, pinned pool, the ingest pool
    turns = []
    uncrashed = None
    metrics.reset_checkpoint_stats()
    for _ in range(CK_PAIRS):
        for ckpt in (True, False):
            secs, got = timed_run(cfg, ckpt)
            check_labels(got, "checkpointed CC" if ckpt else "CC")
            uncrashed = uncrashed if ckpt else got
            turns.append((ckpt, secs))
    ck_stats = metrics.checkpoint_stats()
    snap_eps = [n_edges / s for k, s in turns if k]
    none_eps = [n_edges / s for k, s in turns if not k]
    log(f"  (a) from_arrays(...).aggregate(ConnectedComponents(), checkpoint_path=...) at width {width}, "
        f"wire_checkpoint_batches={CK_EVERY}, superbatch={CK_GROUP}: edges/s in turns, snapshots "
        + ", ".join(f"{e:.6g}" for e in snap_eps) + "; none " + ", ".join(f"{e:.6g}" for e in none_eps))
    saves = max(ck_stats["snapshots"], 1)
    save_ms = ck_stats["snapshot_save_s"] / saves * 1e3
    wait_ms = ck_stats["snapshot_wait_s"] / saves * 1e3
    state = ConnectedComponents().initial_state(cfg, dev)
    carry = ((), state)
    clone_ms, clone_us = device_ms(lambda: checkpoint.tree_map_leaves(lambda t: t.clone(), carry), 20, cpm)
    state_bytes = sum(t.numel() * t.element_size() for t in state)
    log(f"  (a) a snapshot ({state_bytes} B of state): device clone {clone_ms:.4f} ms held (host enqueue "
        f"{clone_us:.1f} us; bound {2 * state_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms), the writer's "
        f"save_state {save_ms:.2f} ms and its wait for the download {wait_ms:.3f} ms a snapshot "
        f"({ck_stats['snapshots']} snapshots over {CK_PAIRS} runs)")

    class CrashingCC(ConnectedComponents):
        """Raises in update on its CK_CRASH_CALL-th call, once; marks the
        first fold after a restore, synchronized."""

        calls = 0
        restarted_at = None
        first_fold_s = None

        def update(self, st, s, d, v, m):
            type(self).calls += 1
            if type(self).calls == CK_CRASH_CALL:
                raise RuntimeError("injected crash in update")
            res = super().update(st, s, d, v, m)
            if type(self).restarted_at is not None and type(self).first_fold_s is None:
                torch.cuda.synchronize()
                type(self).first_fold_s = time.perf_counter() - type(self).restarted_at
            return res

    if os.path.exists(path + ".npz"):
        os.remove(path + ".npz")
    agg = CrashingCC()
    restarts = []
    attempts = []
    like = agg._wire_checkpoint_like(EdgeStream.from_arrays(src, dst, cfg, device=dev))

    def on_restart(n, e):
        snap = checkpoint.load_state(path, like)
        restarts.append((n, str(e), int(snap["next_batch"]), bool(snap["done"])))
        uf.reset_launches()
        wd.reset_launches()

    def make():
        attempts.append(time.perf_counter())
        if len(attempts) == 2:
            CrashingCC.restarted_at = attempts[-1]
        return EdgeStream.from_arrays(src, dst, cfg, device=dev).aggregate(agg, checkpoint_path=path)

    t0 = time.perf_counter()
    records = list(run_supervised(make, max_restarts=1, on_restart=on_restart))
    sup_s = time.perf_counter() - t0
    launches = dict(uf.LAUNCHES)
    if len(restarts) != 1 or len(attempts) != 2:
        raise RuntimeError(f"expected one restart, got {restarts} over {len(attempts)} attempts")
    restored = restarts[0][2]
    if restored != 3 * CK_EVERY or restarts[0][3]:
        raise RuntimeError(f"the restore must resume at batch {3 * CK_EVERY}, got {restarts[0]}")
    got = labels_of(records)
    check_labels(got, "the recovered run")
    if not (np.array_equal(got[0], uncrashed[0]) and np.array_equal(got[1], uncrashed[1])):
        raise RuntimeError("the recovered run's labels differ from the uncrashed run's")
    if launches["union_kernel"] != nb - restored:
        raise RuntimeError(f"the union kernel must launch once a batch after the restore, "
                           f"{nb - restored} times: {launches}")
    recover_ms = CrashingCC.first_fold_s * 1e3
    log(f"  (a) run_supervised(max_restarts=1) with update raising on call {CK_CRASH_CALL}: restarts {restarts}, "
        f"restored next_batch {restored}, union-find launches after the restore {launches} (no refold of batches "
        f"0-{restored - 1}); labels equal to the uncrashed run's and scipy's; {sup_s:.3f} s in all")
    log(f"  (a) time to recover: {recover_ms:.2f} ms from the new aggregate call to the first fold after the "
        f"restore (host, synchronized)")
    busy_a, wall_a, top_a = exact_profile(lambda: timed_run(cfg, True))
    idle_a = None if busy_a is None else 100 * (1 - busy_a / wall_a)
    log(f"  (a) torch.profiler over one snapshotted run: device busy {busy_a} ms (the sum of its kernel, copy and "
        f"set rows) against that run's own wall {wall_a:.1f} ms: idle {'-' if idle_a is None else f'{idle_a:.2f}'}%; "
        f"top rows {top_a}")
    out["a"] = {"edges_per_s_snapshots": snap_eps, "edges_per_s_none": none_eps, "clone_ms": clone_ms,
                "clone_host_us": clone_us, "save_ms": save_ms, "wait_ms": wait_ms, "state_bytes": state_bytes,
                "restarts": len(restarts), "restored_next_batch": restored, "launches_after_restore": launches,
                "recover_ms": recover_ms, "idle_pct": idle_a, "busy_ms": busy_a, "profiled_wall_ms": wall_a,
                "top": top_a, "width": str(width)}

    # (b) the compressed and the binned ingest
    ef40_b = sum(b.nbytes for b in data["bufs"]) / n_edges
    plain_b = wire.wire_nbytes(batch, wire.width_for_capacity(c)) / batch
    res_b = {}
    for label, kw in (("compressed", dict(wire_compress=1)), ("binned", dict(binned_ingest=1, wire_encoding="plain"))):
        bcfg = StreamConfig(vertex_capacity=c, batch_size=batch, superbatch=CK_GROUP, **kw)
        EdgeStream.from_arrays(src[: 2 * batch], dst[: 2 * batch], bcfg, device=dev).aggregate(
            ConnectedComponents()).collect()
        torch.cuda.synchronize()
        wd.reset_launches()
        native.reset_calls()
        metrics.reset_wire_stats()
        t0 = time.perf_counter()
        recs = EdgeStream.from_arrays(src, dst, bcfg, device=dev).aggregate(ConnectedComponents()).collect()
        got = labels_of(recs)
        secs = time.perf_counter() - t0
        check_labels(got, label)
        if not (np.array_equal(got[0], uncrashed[0]) and np.array_equal(got[1], uncrashed[1])):
            raise RuntimeError(f"{label}: labels differ from (a)'s")
        calls, w = dict(native.CALLS), metrics.wire_stats()
        if calls["sort_edges_dst_src"] < nb:
            raise RuntimeError(f"{label}: the native sorter was not called on every batch: {calls}")
        if label == "compressed":
            if wd.LAUNCHES["bdv_decode"] != nb:
                raise RuntimeError(f"bdv_decode must launch once a batch on the compressed path: {wd.LAUNCHES}")
            if calls["encode_edges_bdv"] < nb:
                raise RuntimeError(f"the native encoder was not called on every batch: {calls}")
        elif calls["pack_edges40"] < nb:
            raise RuntimeError(f"the native packer was not called on every batch: {calls}")
        res_b[label] = {"edges_per_s": n_edges / secs, "wire_bytes_per_edge": w["wire_bytes_per_edge"],
                        "bin_occupancy_hwm": w["wire_bin_occupancy_hwm"], "native_calls": {
                            k: v for k, v in calls.items() if v}, "decode_launches": wd.LAUNCHES["bdv_decode"],
                        "wall_s": secs}
        log(f"  (b) {label} ({kw}, superbatch={CK_GROUP}): {n_edges / secs:.6g} edges/s end to end, "
            f"{w['wire_bytes_per_edge']} wire B/edge "
            f"(plain width {plain_b:.1f}, EF40 {ef40_b:.4f}), bin occupancy high-water "
            f"{w['wire_bin_occupancy_hwm']}; native calls {res_b[label]['native_calls']}; bdv_decode launches "
            f"{wd.LAUNCHES['bdv_decode']}; labels equal to (a)'s and scipy's")
    for label, fn in (("compressed", lambda s, d: wire.pack_edges_bdv(s, d, c, record_stats=True)),
                      ("binned", lambda s, d: wire.pack_edges(*wire.sort_edges_binned(s, d, c), wire.PAIR40))):
        t0 = time.perf_counter()
        for i in range(2):
            fn(src[i * batch : (i + 1) * batch], dst[i * batch : (i + 1) * batch])
        res_b[label]["pack_ms"] = (time.perf_counter() - t0) / 2 * 1e3
    bdv_buf = wire.pack_edges_bdv(src[-batch:], dst[-batch:], c)
    b_dev = to_dev((bdv_buf,), dev)[0]
    got = wd.decode_bdv(b_dev, batch)
    want = wd.decode_bdv_plain(b_dev, batch)
    err = max(int((g.to(torch.int64) - w_.to(torch.int64)).abs().max()) for g, w_ in zip(got, want))
    dec_ms, dec_us = device_ms(lambda: wd.decode_bdv(b_dev, batch), 50, cpm)
    dec_events_ms = cuda_ms(lambda: wd.decode_bdv(b_dev, batch), 50)
    twin_ms = cuda_ms(lambda: wd.decode_bdv_plain(b_dev, batch), 10)
    payload = bdv_payload_nbytes(bdv_buf, batch)
    bound_ms = (payload + 8 * batch) / HBM_BYTES_PER_S * 1e3
    ccfg = StreamConfig(vertex_capacity=c, batch_size=batch, superbatch=CK_GROUP, wire_compress=1)
    busy_b, wall_b, top_b = exact_profile(lambda: EdgeStream.from_arrays(src, dst, ccfg, device=dev).aggregate(
        ConnectedComponents()).collect())
    idle_b = None if busy_b is None else 100 * (1 - busy_b / wall_b)
    log(f"  (b) one batch's pack on one thread: BDV (native sort + encode) {res_b['compressed']['pack_ms']:.2f} ms, "
        f"binned (native sort + PAIR40) {res_b['binned']['pack_ms']:.2f} ms (the runs above pack a group's "
        f"{CK_GROUP} batches across the ingest pool's {ingest.resolve_workers(0)} workers)")
    log(f"  (b) bdv_decode a batch ({payload} B of payload in a {bdv_buf.nbytes} B bucket, {batch} edges): device "
        f"{dec_ms:.5f} ms held, host enqueue {dec_us:.2f} us, events {dec_events_ms:.5f} ms; bound {bound_ms:.5f} ms "
        f"(bytes: the payload read once, 8 B an edge written), {dec_ms / bound_ms:.2f}x the bound; the twin "
        f"{twin_ms:.4f} ms; max_abs_err {err}")
    log(f"  (b) torch.profiler over one compressed run: device busy {busy_b} ms against that run's own wall "
        f"{wall_b:.1f} ms: idle {'-' if idle_b is None else f'{idle_b:.2f}'}%; top rows {top_b}")
    out["b"] = {**res_b, "plain_bytes_per_edge": plain_b, "ef40_bytes_per_edge": ef40_b, "idle_pct": idle_b,
                "busy_ms": busy_b, "profiled_wall_ms": wall_b, "top": top_b}
    out["decode"] = {"launches": res_b["compressed"]["decode_launches"], "err": err, "ms": dec_events_ms,
                     "device_ms": dec_ms, "host_us": dec_us, "plain_ms": twin_ms, "bound_ms": bound_ms,
                     "ratio": dec_ms / bound_ms, "payload_bytes": payload, "wire_bytes": bdv_buf.nbytes}
    if parent is not None:
        out["decode"]["turns"] = bdv_turns(cpm, b_dev, batch, parent, variants)

    # (c) bdv_decode and ef40_unpack against their twins on the card
    cases = bdv_cases(np.random.default_rng(19))
    cases.insert(0, ("CC batch", [(bdv_buf, batch, False)]))
    checked, bad = bdv_check_cases(dev, cases)
    if bad or err:
        raise RuntimeError(f"bdv_decode differs from its twin on {bad} of {checked} buffers")
    log(f"  (c) bdv_decode bit-equal to its twin on {checked} buffers: " + ", ".join(
        f"{label} ({len(items)})" for label, items in cases))
    e_cases = ef40_cases(np.random.default_rng(26), data)
    e_checked, e_bad = ef40_check_cases(dev, e_cases)
    if e_bad:
        raise RuntimeError(f"ef40_unpack differs from its twin on {e_bad} of {e_checked} buffers")
    log(f"  (c) ef40_unpack bit-equal to its twin on {e_checked} buffers, one launch each: " + ", ".join(
        f"{label} ({len(items)})" for label, items in e_cases))
    out["c"] = {"buffers": checked, "ef40_buffers": e_checked}
    out["s"] = time.perf_counter() - t_phase
    log(f"  phase 19: {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: the network edge source, the measurement programs, wire_unpack

NET_VERTICES = 1 << 20  # (a): C
NET_WINDOW = 1 << 21  # ingest_window_edges
NET_BATCH = 1 << 19
NET_PUSHES = 32  # 31 PAIR40 buffers and a tail of one batch: 8 windows
NET_SHORT_PUSHES = 8  # the EF40, BDV and CPU runs: 2 windows
NET_QUEUE = 4  # max_queued_batches: the pusher waits on the job
NET_CRASH_SAVES = 2  # (a): the crash after the 2nd snapshot
# (b): every mode at the JAX program's defaults, with the flags that reach
# the rest of its path (the trace, both spanner bodies, sage's training);
# spanner's CPU run takes over 30 s, so its fields are held against the
# plain-Python spanner_oracle in a process of its own
MEASURE_RUNS = (["degrees", "--trace"], ["bipartiteness"], ["triangles"], ["spanner", "--body", "both"],
                ["matching"], ["replay"], ["sage", "--train-steps", "20"], ["pagerank"], ["sssp"], ["kcore"])
MEASURED_KEY = re.compile(r"per_sec|eps$|_ms$|_ms_|gbps|runtime|loss|winner|crossover")
UNPACK_NS = (1, 2, 3, 31, 1 << 16, 1 << 21)  # (c)
UNPACK_REPS = 100


class InjectedCrash(RuntimeError):
    """The crash phase 20 (a) injects into a checkpointed run."""


def unpack_bound_ms(n: int, width) -> float:
    """A fixed-width unpack's bytes bound: the wire read once, src and dst
    written."""
    return ((5 * n if width == "pair40" else 2 * width * n) + 8 * n) / HBM_BYTES_PER_S * 1e3


def idle_pct(busy_ms, wall_ms):
    return None if busy_ms is None else 100.0 * (1.0 - busy_ms / wall_ms)


def net_push(src, width_bufs, s, d, start: int, pushes: int, mid: dict = None):
    """A pusher thread: buffers k = start/B .. through push_wire with their
    offsets, then the last batch through push_tail, then close().  A
    refusal after a crash (the consumer quiesced the source) ends it."""
    from gelly_streaming_tpu_torch.io import sources

    b = NET_BATCH
    errors = []

    def push(fn, *args, **kw):
        # a bounded wait, then the push again: its first step refuses
        # (SourceQuiesced) once the job's side has quiesced the source
        while True:
            try:
                return fn(*args, timeout=1.0, **kw)
            except queue.Full:
                pass

    def run():
        try:
            k0 = start // b
            for k in range(k0, pushes - 1):
                buf, width = width_bufs(k)
                push(src.push_wire, buf, width, offset=k * b)
                if mid is not None and k == pushes // 2:
                    mid.update(src.progress())
            push(src.push_tail, s[(pushes - 1) * b : pushes * b], d[(pushes - 1) * b : pushes * b],
                 offset=(pushes - 1) * b)
            src.close()
        except sources.SourceQuiesced:
            pass
        except BaseException as e:  # raised on the phase's thread
            errors.append(e)

    th = threading.Thread(target=run)
    th.start()
    return th, errors


def net_job(dev, cfg_kw: dict, width_bufs, s, d, pushes: int = NET_PUSHES, checkpoint_path=None,
            resume_edges: int = 0, mid: dict = None):
    """(records, seconds) of a windowed CC job over a NetworkEdgeSource fed
    by a pusher thread; a failed job quiesces the source, so the pusher's
    next push (a bounded wait) refuses and the thread ends."""
    import torch
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.io.sources import NetworkEdgeSource
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents

    cfg = StreamConfig(vertex_capacity=NET_VERTICES, batch_size=NET_BATCH, ingest_window_edges=NET_WINDOW,
                       **cfg_kw)
    src = NetworkEdgeSource(cfg, NET_BATCH, resume_edges=resume_edges, max_queued_batches=NET_QUEUE, device=dev)
    t0 = time.perf_counter()
    th, errors = net_push(src, width_bufs, s, d, resume_edges, pushes, mid)
    try:
        job = src.stream().aggregate(ConnectedComponents(), checkpoint_path=checkpoint_path)
        records = job.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        if th.is_alive():
            src.quiesce()  # the pusher's next push, or its wait's end, refuses
        th.join()
    if errors:
        raise errors[0]
    return records, seconds


def cc_records_equal(a, b) -> bool:
    import torch

    return len(a) == len(b) > 0 and all(
        torch.equal(x[0].parent.cpu(), y[0].parent.cpu()) and torch.equal(x[0].seen.cpu(), y[0].seen.cpu())
        for x, y in zip(a, b))


def phase_network(dev, cpm) -> dict:
    """(a) the network edge source on the card; returns its figures."""
    import torch
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import sources, wire
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents
    from gelly_streaming_tpu_torch.ops import unionfind as uf
    from gelly_streaming_tpu_torch.utils import checkpoint, metrics

    t_phase = time.perf_counter()
    b, c = NET_BATCH, NET_VERTICES
    rng = np.random.default_rng(0)
    n = NET_PUSHES * b
    s = rng.integers(0, c, n).astype(np.int32)
    d = rng.integers(0, c, n).astype(np.int32)
    t0 = time.perf_counter()
    pair40 = [wire.pack_edges(s[k * b : (k + 1) * b], d[k * b : (k + 1) * b], wire.PAIR40)
              for k in range(NET_PUSHES - 1)]
    log(f"  {NET_PUSHES - 1} PAIR40 buffers of {b} edges packed in {time.perf_counter() - t0:.3f} s (untimed)")

    def by_pair40(k):
        return pair40[k], wire.PAIR40

    cfg = StreamConfig(vertex_capacity=c, batch_size=b, ingest_window_edges=NET_WINDOW)
    ref = EdgeStream.from_arrays(s, d, cfg, batch_size=b, device=dev).aggregate(ConnectedComponents()).collect()
    if len(ref) != n // NET_WINDOW:
        raise RuntimeError(f"the from_arrays reference emitted {len(ref)} records, not {n // NET_WINDOW}")
    out = {"edges": n, "windows": len(ref), "batch": b, "window_edges": NET_WINDOW, "vertices": c}
    for plane, kw in (("sync", {}), (f"async {ASYNC_DEPTH}", {"async_windows": ASYNC_DEPTH})):
        net_job(dev, kw, by_pair40, s, d, pushes=NET_SHORT_PUSHES)  # warm this plane
        metrics.reset_histograms()
        uf.reset_launches()
        mid = {}
        recs, secs = net_job(dev, kw, by_pair40, s, d, mid=mid)
        union_launches = uf.LAUNCHES["union_kernel"]
        if not union_launches:
            raise RuntimeError(f"network source, {plane}: the CC fold launched no union_kernel: {uf.LAUNCHES}")
        if not cc_records_equal(recs, ref):
            raise RuntimeError(f"network source, {plane}: the records differ from the from_arrays stream's")
        hist = metrics.hist_snapshot()["global"]["push_to_fold_ms"]
        if hist["count"] != NET_PUSHES:
            raise RuntimeError(f"push_to_fold_ms counted {hist['count']} pulls, not {NET_PUSHES}")
        out[plane] = {"edges_per_s": n / secs, "s": secs, "push_to_fold_p50_ms": hist["p50_ms"],
                      "push_to_fold_p99_ms": hist["p99_ms"], "push_to_fold_max_ms": hist["max_ms"],
                      "progress_at_midpoint": mid, "union_kernel_launches": union_launches}
        log(f"  {plane}: {len(recs)} windows equal to from_arrays on the card, union_kernel launched "
            f"{union_launches} times; {n / secs:.6g} edges/s "
            f"({secs:.3f} s), push-to-fold p50 {hist['p50_ms']} ms p99 {hist['p99_ms']} ms; progress() after "
            f"push {NET_PUSHES // 2}: {mid}")
    busy, wall, top = exact_profile(lambda: net_job(dev, {}, by_pair40, s, d), require=("union_kernel",))
    out["idle_pct"] = idle_pct(busy, wall)
    out["busy_ms"], out["profiled_wall_ms"], out["top"] = busy, wall, top
    log(f"  sync run under torch.profiler: device busy {busy} ms of {wall:.1f} ms wall, idle "
        f"{out['idle_pct']}%; top {top}")
    # the first two windows against the port on the CPU
    cpu_recs, _ = net_job(torch.device("cpu"), {}, by_pair40, s, d, pushes=NET_SHORT_PUSHES)
    if not cc_records_equal(cpu_recs, ref[: len(cpu_recs)]) or len(cpu_recs) != 2:
        raise RuntimeError("network source: the CPU run's two windows differ from the card's")
    log("  the first 2 windows equal the port's run on device='cpu'")
    # EF40 and BDV pushes, two windows
    t0 = time.perf_counter()
    short = {name: [wire.pack_edges_bdv(s[k * b : (k + 1) * b], d[k * b : (k + 1) * b], c) if name == "bdv"
                     else wire.pack_edges(s[k * b : (k + 1) * b], d[k * b : (k + 1) * b], (wire.EF40, c))
                     for k in range(NET_SHORT_PUSHES - 1)] for name in ("ef40", "bdv")}
    log(f"  EF40 and BDV buffers for 2 windows packed in {time.perf_counter() - t0:.2f} s (untimed)")
    for name, width in (("ef40", (wire.EF40, c)), ("bdv", (wire.BDV, c))):
        recs, secs = net_job(dev, {}, lambda k, name=name, width=width: (short[name][k], width), s, d,
                             pushes=NET_SHORT_PUSHES)
        if not cc_records_equal(recs, ref[:2]):
            raise RuntimeError(f"network source, {name}: the records differ from the from_arrays stream's")
        out[name] = {"edges_per_s": NET_SHORT_PUSHES * b / secs, "bytes_per_edge":
                     sum(x.nbytes for x in short[name]) / ((NET_SHORT_PUSHES - 1) * b)}
        log(f"  {name}: 2 windows equal; {out[name]['edges_per_s']:.6g} edges/s, "
            f"{out[name]['bytes_per_edge']:.3f} wire bytes an edge")
    # crash after the 2nd snapshot, resume from the snapshot's cursor
    ck_dir = tempfile.mkdtemp(prefix="net_ck_")
    try:
        path = os.path.join(ck_dir, "cc")
        real_save, saves = checkpoint.save_state, []

        def crashing_save(p, state):
            real_save(p, state)
            saves.append(p)
            if len(saves) == NET_CRASH_SAVES:
                raise InjectedCrash("after the 2nd snapshot")

        checkpoint.save_state = crashing_save
        try:
            try:
                net_job(dev, {}, by_pair40, s, d, checkpoint_path=path)
            except InjectedCrash:
                pass
            else:
                raise RuntimeError("the checkpointed run did not crash")
        finally:
            checkpoint.save_state = real_save
        _, last, _ = ConnectedComponents()._restore_merge(cfg, dev, path, True)
        cursor = (last + 1) * NET_WINDOW
        probe = sources.NetworkEdgeSource(cfg, b, resume_edges=cursor, device=dev)
        try:
            probe.push_wire(pair40[0], wire.PAIR40, offset=0)
            raise RuntimeError("a stale offset was accepted")
        except sources.PushOutOfSync as e:
            if e.expected != cursor or e.declared != 0:
                raise RuntimeError(f"PushOutOfSync carries {e.expected}/{e.declared}, not {cursor}/0")
        t0 = time.perf_counter()
        resumed, _ = net_job(dev, {}, by_pair40, s, d, checkpoint_path=path, resume_edges=cursor)
        resume_s = time.perf_counter() - t0
        if not cc_records_equal(resumed, ref[len(ref) - len(resumed):]) or not resumed:
            raise RuntimeError("the resumed run's records differ from the clean run's")
        out["crash"] = {"cursor_edges": cursor, "snapshots_before_crash": len(saves), "resumed_records":
                        len(resumed), "resume_s": resume_s}
        log(f"  crashed after snapshot {len(saves)}: cursor {cursor} edges; a stale push refused PushOutOfSync "
            f"(expected {cursor}); resumed from the cursor in {resume_s:.3f} s, {len(resumed)} records and the "
            "final state equal to the clean run's")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    out["s"] = time.perf_counter() - t_phase
    return out


def measurement_fields(out: dict) -> dict:
    return {k: v for k, v in out.items() if not MEASURED_KEY.search(k)}


def phase_measurements(dev, oracle_pool) -> dict:
    """(b) every measurement program on the card, held against the port's
    CPU run with the same arguments (the spanner against the oracle)."""
    import contextlib
    import io

    from gelly_streaming_tpu_torch.examples import measurements
    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    t_phase = time.perf_counter()
    spanner_args = measurements.parser().parse_args(next(a for a in MEASURE_RUNS if a[0] == "spanner"))
    rng = np.random.default_rng(spanner_args.seed)
    sp_src = rng.integers(0, spanner_args.vertices, spanner_args.edges).astype(np.int32)
    sp_dst = rng.integers(0, spanner_args.vertices, spanner_args.edges).astype(np.int32)
    oracle = oracle_pool.apply_async(spanner_oracle, (sp_src, sp_dst, spanner_args.vertices,
                                                      spanner_args.max_degree, spanner_args.k))
    out, launches = {}, {}
    for argv in MEASURE_RUNS:
        mode = argv[0]
        wd.reset_launches()
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            measurements.main(argv)
        secs = time.perf_counter() - t0
        launches[mode] = dict(wd.LAUNCHES)
        got = json.loads(text.getvalue().strip().splitlines()[-1])
        log(f"  {' '.join(argv)} ({secs:.1f} s): {json.dumps(got)}")
        if wd.TWIN_CALLS["wire_unpack"]:
            raise RuntimeError(f"{mode}: the wire_unpack twin ran on the card")
        if mode == "spanner":
            ref = None
        else:
            t0 = time.perf_counter()
            ref = measurements.run(argv + ["--device=cpu"])
            if list(ref) != list(got) or measurement_fields(ref) != measurement_fields(got):
                raise RuntimeError(f"{mode}: the card's fields differ from the CPU run's:\n {got}\n {ref}")
            log(f"    the CPU run with the same arguments ({time.perf_counter() - t0:.1f} s) agrees on "
                f"{sorted(measurement_fields(ref))}")
        out[mode] = {"out": got, "s": secs}
    deg, bip = out["degrees"]["out"], out["bipartiteness"]["out"]
    batches = deg["edges_folded"] // measurements.parser().parse_args(MEASURE_RUNS[0]).batch
    if deg["degree_total"] != 2 * deg["edges_folded"] or deg.get("flink_proxy_counts_ok") is not True:
        raise RuntimeError(f"degrees: {deg}")
    if deg["trace_records"] != 2 * deg["edges_folded"]:
        raise RuntimeError(f"degrees --trace: {deg['trace_records']} records for {deg['edges_folded']} edges")
    # the fold's batches, then the trace's two drains of the from_wire replay
    want = {"degrees": 3 * batches, "bipartiteness": batches}
    for mode, count in want.items():
        if launches[mode]["wire_unpack"] != count:
            raise RuntimeError(f"{mode}: wire_unpack launched {launches[mode]['wire_unpack']} times, not once a "
                               f"batch ({count})")
    log(f"  wire_unpack launches: degrees --trace {launches['degrees']['wire_unpack']} (the fold's {batches} "
        f"batches and two get_degrees drains over from_wire, {batches} each), bipartiteness "
        f"{launches['bipartiteness']['wire_unpack']}; the twin never")
    table = oracle.get(timeout=600)
    sp = out["spanner"]["out"]
    if sp["spanner_edges"] != int((table >= 0).sum()) // 2 or sp["bodies_agree"] is not True:
        raise RuntimeError(f"spanner: {sp['spanner_edges']} edges against the oracle's {int((table >= 0).sum()) // 2}")
    log(f"  spanner: {sp['spanner_edges']} edges, equal to spanner_oracle's; both bodies agree")
    busy, wall, top = exact_profile(lambda: measurements.run([a for a in MEASURE_RUNS[0] if a != "--trace"]),
                                    require=("wire_unpack_kernel", "degree_fold_kernel"))
    out["degrees_idle_pct"] = idle_pct(busy, wall)
    log(f"  measurements degrees under torch.profiler: device busy {busy} ms of {wall:.1f} ms wall, idle "
        f"{out['degrees_idle_pct']}%; top {top}")
    out["launches"] = launches["degrees"]["wire_unpack"] + launches["bipartiteness"]["wire_unpack"]
    out["bipartite"] = bip["bipartite"]
    out["s"] = time.perf_counter() - t_phase
    return out


def unpack_cases(rng):
    """(wire buffer, n, width, src, dst): widths 3 and PAIR40 over UNPACK_NS,
    ids 0 and C - 1, values across PAIR40's bit-19/20 seam."""
    from gelly_streaming_tpu_torch.io import wire

    for width, cap in ((3, 1 << 24), (wire.PAIR40, 1 << 20)):
        for n in UNPACK_NS:
            s = rng.integers(0, cap, n).astype(np.int32)
            d = rng.integers(0, cap, n).astype(np.int32)
            s[0], d[-1] = cap - 1, 0
            if n > 4:
                s[1:4] = (1 << 19) - 1, 1 << 19, (1 << 20) - 1
                d[1:4] = 0, cap - 1, (1 << 19) + 1
            yield wire.pack_edges(s, d, width), n, width, s, d


def phase_unpack(dev, cpm) -> dict:
    """(c) wire_unpack against its twin, then its times."""
    import torch
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    rng = np.random.default_rng(20)
    checked = 0
    for buf, n, width, s, d in unpack_cases(rng):
        big = torch.full((buf.nbytes + 48,), 0xA5, dtype=torch.uint8, device=dev)
        for off in range(16):
            view = big[off : off + buf.nbytes]
            view.copy_(torch.from_numpy(buf))
            got = wd.unpack_edges_fixed(view, n, width)
            want = wd.unpack_edges_fixed_plain(view, n, width)
            if not (all(torch.equal(g, w) for g, w in zip(got, want))
                    and np.array_equal(got[0].cpu().numpy(), s) and np.array_equal(got[1].cpu().numpy(), d)):
                raise RuntimeError(f"wire_unpack differs from its twin: width {width}, n {n}, offset {off}")
            checked += 1
    log(f"  wire_unpack equal to its twin and to the packed ids on {checked} buffers (widths 3 and PAIR40, n in "
        f"{list(UNPACK_NS)}, offsets 0-15 of a larger allocation, lengths no multiple of 16 among them)")
    # get_degrees over a PAIR40 from_wire replay: once a batch
    c, b, nb = 1 << 17, 1 << 16, 16
    s = rng.integers(0, c, nb * b).astype(np.int32)
    d = rng.integers(0, c, nb * b).astype(np.int32)
    bufs, _ = wire.pack_stream(s, d, b, wire.PAIR40)
    wd.reset_launches()
    recs = EdgeStream.from_wire(bufs, b, wire.PAIR40, StreamConfig(vertex_capacity=c, batch_size=b),
                                device=dev).get_degrees().collect()
    if wd.LAUNCHES["wire_unpack"] != nb or wd.TWIN_CALLS["wire_unpack"] or len(recs) != 2 * nb * b:
        raise RuntimeError(f"get_degrees over from_wire: {wd.LAUNCHES}, twins {wd.TWIN_CALLS}, {len(recs)} records")
    log(f"  get_degrees over a PAIR40 from_wire replay of {nb} batches: wire_unpack launched {nb} times")
    times = {}
    for label, n, width in (("pair40_2^21", 1 << 21, wire.PAIR40), ("3_2^21", 1 << 21, 3),
                            ("pair40_2^16", 1 << 16, wire.PAIR40)):
        cap = 1 << 20
        buf = to_dev((wire.pack_edges(rng.integers(0, cap, n).astype(np.int32),
                                      rng.integers(0, cap, n).astype(np.int32), width),), dev)[0]
        d_ms, h_us = device_ms(lambda: wd.unpack_edges_fixed(buf, n, width), UNPACK_REPS, cpm)
        ev_ms = cuda_ms(lambda: wd.unpack_edges_fixed(buf, n, width), UNPACK_REPS)
        twin_ms = cuda_ms(lambda: wd.unpack_edges_fixed_plain(buf, n, width), 20)
        twin_dev_ms, _ = device_ms(lambda: wd.unpack_edges_fixed_plain(buf, n, width), 20, cpm)
        bound = unpack_bound_ms(n, width)
        times[label] = {"n": n, "width": width, "device_ms": d_ms, "host_us": h_us, "ms": ev_ms,
                        "plain_ms": twin_ms, "plain_device_ms": twin_dev_ms, "bound_ms": bound,
                        "ratio": d_ms / bound}
        log(f"  wire_unpack {label}: device {d_ms:.5f} ms (bound {bound:.5f} ms, {d_ms / bound:.2f}x), host "
            f"{h_us:.2f} us a call, back-to-back events {ev_ms:.5f} ms; the twin (the widening torch ops) {twin_ms:.5f} ms "
            f"events, {twin_dev_ms:.5f} ms held")
    # widths 2 and 4 keep their PyTorch ops (io/wire.unpack_edges): timed
    # for the open item, no kernel
    for width, cap in ((2, 1 << 16), (4, 1 << 20)):
        n = 1 << 21
        buf = to_dev((wire.pack_edges(rng.integers(0, cap, n).astype(np.int32),
                                      rng.integers(0, cap, n).astype(np.int32), width),), dev)[0]
        ops_dev_ms, ops_us = device_ms(lambda: wire.unpack_edges(buf, n, width), 20, cpm)
        ops_ms = cuda_ms(lambda: wire.unpack_edges(buf, n, width), 20)
        bound = unpack_bound_ms(n, width)
        times[f"ops_{width}_2^21"] = {"n": n, "width": width, "device_ms": ops_dev_ms, "host_us": ops_us,
                                      "ms": ops_ms, "bound_ms": bound, "ratio": ops_dev_ms / bound}
        log(f"  width {width}'s torch ops, 2^21 edges: device {ops_dev_ms:.5f} ms (bound {bound:.5f} ms, "
            f"{ops_dev_ms / bound:.2f}x), host {ops_us:.2f} us a call, back-to-back events {ops_ms:.5f} ms")
    return {"checked": checked, "times": times}


def phase_twenty(dev, cpm) -> dict:
    """Phase 20: (a) the network source, (b) the measurement programs,
    (c) wire_unpack; the spanner oracle runs in a process of its own."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        log("  (a) NetworkEdgeSource: windowed CC over stream() at C = 2^20, 8 windows of 2^21, pushes of 2^19")
        net = phase_network(dev, cpm)
        log("  (b) the measurement programs at the JAX program's defaults")
        meas = phase_measurements(dev, pool)
        log("  (c) wire_unpack against its twin, and its times")
        unpack = phase_unpack(dev, cpm)
    finally:
        pool.terminate()
        pool.join()
    return {"network": net, "measurements": meas, "unpack": unpack}


# ---------------------------------------------------------------------------
# phase 21: the mesh aggregation plane, S shards sharing the card.  No
# multi-GPU speed is measured here: every mesh number is S shards on one
# H100, folding one after another on its stream.

MESH_SHARDS = 4
MESH_ROW = CC_BATCH // MESH_SHARDS  # (a): from_arrays at batch 2^21, a row of 2^19 a shard
MESH_CKPT_ROWS = 100  # (a): a snapshot every 25 groups of 4 rows
MESH_KILL_GROUP = 37  # (a): the crash after group 37 of 50; the snapshot says 25
MESH_WIN_EDGES = 1 << 15  # (b): 16 tumbling (ingestion-count) windows of 2^15 edges
MESH_WINDOWS = 16
MESH_HUB_WINDOW = 5  # (b): half of this window's edges on one hub
ROUTE_SHARDS, ROUTE_PER_SHARD, ROUTE_CAP = 8, 1 << 20, 1 << 18  # (c)


class MeshCrash(RuntimeError):
    """The crash phase 21 (a) injects into a checkpointed run."""


def mesh_kernel_modules() -> tuple:
    """The ops modules whose kernels the mesh plane's main path launches."""
    from gelly_streaming_tpu_torch.ops import degrees as dg
    from gelly_streaming_tpu_torch.ops import routing as rk
    from gelly_streaming_tpu_torch.ops import unionfind as uf
    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    return rk, uf, wd, dg


def mesh_reset() -> None:
    """Zero every count the mesh plane's main path reads."""
    from gelly_streaming_tpu_torch.parallel import mesh as pm
    from gelly_streaming_tpu_torch.utils import metrics

    for mod in mesh_kernel_modules():
        mod.reset_launches()
    pm.HOST_SYNCS["reads"] = 0
    metrics.reset_comms_stats()


def mesh_counts() -> dict:
    """Each kernel's launches (the routing and union-find kernels always,
    the others where they launched), the twins' calls, the host syncs and
    the comms counters since ``mesh_reset``."""
    from gelly_streaming_tpu_torch.parallel import mesh as pm
    from gelly_streaming_tpu_torch.utils import metrics

    rk, uf, wd, dg = mesh_kernel_modules()
    launches = {**rk.LAUNCHES, **uf.LAUNCHES}
    for mod in (wd, dg):
        launches.update({k: v for k, v in mod.LAUNCHES.items() if v})
    return {"launches": launches,
            "twin_calls": sum(sum(getattr(mod, "TWIN_CALLS", {}).values()) for mod in mesh_kernel_modules()),
            "host_syncs": pm.HOST_SYNCS["reads"], "comms": metrics.comms_stats()}


def mesh_main(label: str, fn, need=(), profile: bool = False) -> tuple:
    """(result, seconds, counts, device busy ms | None): one main-path run
    from zeroed counts; raises unless every kernel in ``need`` launched and
    no twin ran."""
    import torch

    mesh_reset()
    torch.cuda.synchronize()
    busy = None
    t0 = time.perf_counter()
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = 0.0
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            total += (us if us is not None else getattr(evt, "self_cuda_time_total", 0)) or 0
        busy = total / 1e3 if total else None
    else:
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = mesh_counts()
    missing = [k for k in need if not counts["launches"].get(k)]
    if missing or counts["twin_calls"]:
        raise RuntimeError(f"{label}: kernels not launched {missing} (or twins ran): {counts}")
    return out, wall, counts, busy


def same_labels(label: str, rec, want) -> None:
    ds = rec[-1][0] if isinstance(rec, list) else rec
    p, sn = ds.parent.cpu().numpy(), ds.seen.cpu().numpy()
    if not (np.array_equal(p, want[0]) and np.array_equal(sn, want[1])):
        raise RuntimeError(f"{label}: labels differ from phase 7's")


def mesh_regimes(runner) -> dict:
    """The exchanges of a run by the regime each took, as the runner
    recorded them; the replicated plane exchanges nothing."""
    return dict(runner.exchange_regimes) or {"replicated": 0}


def mesh_log(label: str, edges: int, wall: float, counts: dict, busy=None) -> dict:
    c = counts["comms"]
    idle = idle_pct(busy, wall * 1e3)
    log(f"    {label}: {edges / wall:.6g} edges/s ({wall:.3f} s), exchange rounds {c['comms_exchange_rounds']}, "
        f"host syncs {counts['host_syncs']}, delta hwm {c['comms_delta_occupancy_hwm']}, spilled "
        f"{c['comms_delta_spilled']}, comms {c}, launches {counts['launches']}"
        + ("" if idle is None else f", device idle {idle:.1f}% (torch.profiler)"))
    return {"edges_per_s": edges / wall, "s": wall, **counts, "idle_pct": idle}


def phase_mesh_wire(dev, data: dict) -> dict:
    """(a) the mesh wire streaming fold of CC at the bench shape, both
    planes, and a checkpointed run killed mid-stream and resumed."""
    from gelly_streaming_tpu_torch.core.aggregation import MeshAggregationRunner
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents
    from gelly_streaming_tpu_torch.parallel import mesh as pm

    c, batch = CC_VERTICES, CC_BATCH
    src, dst, want = data["src"], data["dst"], data["labels"]
    n = len(src)
    mesh = pm.make_mesh(MESH_SHARDS, [dev] * MESH_SHARDS)
    cfg = StreamConfig(vertex_capacity=c, batch_size=batch, num_shards=MESH_SHARDS, sharded_state=1)
    need = ("union_kernel", "ef40_unpack", "slab_fold")
    out = {}
    groups = n // MESH_ROW // MESH_SHARDS
    runner = MeshAggregationRunner(ConnectedComponents(), mesh)
    stream = EdgeStream.from_arrays(src, dst, cfg, device=dev)
    recs, wall, counts, busy = mesh_main("(a) sharded", lambda: list(runner.wire_records(stream)), need, True)
    same_labels("(a) sharded from_arrays", recs, want)
    regime = mesh_regimes(runner)
    if not any(k.startswith("dense") for k in regime):
        raise RuntimeError(f"(a): the bench shape's exchange must take the dense regime: {regime}")
    if counts["launches"]["ef40_unpack"] != n // MESH_ROW:
        raise RuntimeError(f"(a): ef40_unpack must launch once a row: {counts}")
    out["sharded_from_arrays"] = {**mesh_log(f"sharded plane, from_arrays (rows packed on the pack thread), {regime}",
                                             n, wall, counts, busy), "regime": regime}
    log("    labels and seen equal phase 7's, bit for bit")

    width = wire.replay_width(c, MESH_ROW)
    t0 = time.perf_counter()
    rows = pack_batches(src, dst, MESH_ROW, width)
    log(f"    {len(rows)} rows of {MESH_ROW} packed at {width} for the replays in {time.perf_counter() - t0:.1f} s "
        "(host threads, untimed)")
    for plane, sh in (("sharded", 1), ("replicated", 0)):
        rcfg = dataclasses.replace(cfg, sharded_state=sh)
        rrunner = MeshAggregationRunner(ConnectedComponents(), mesh)
        rstream = EdgeStream.from_wire(rows, MESH_ROW, width, rcfg, device=dev)
        recs, wall, counts, busy = mesh_main(f"(a) {plane}", lambda: list(rrunner.wire_records(rstream)),
                                             need, profile=plane == "replicated")
        same_labels(f"(a) {plane} replay", recs, want)
        out[f"{plane}_replay"] = {**mesh_log(f"{plane} plane, replay rows, {mesh_regimes(rrunner)}", n, wall,
                                             counts, busy), "regime": mesh_regimes(rrunner)}

    # the checkpointed run: a snapshot every 25 groups, a crash after
    # group 37, a resume that folds groups 25..49 and nothing before
    class Crashing(MeshAggregationRunner):
        def __init__(self, *a):
            super().__init__(*a)
            self.steps = 0

        def _wire_step(self, *a):
            if self.steps == MESH_KILL_GROUP:
                raise MeshCrash(f"injected after group {MESH_KILL_GROUP}")
            self.steps += 1
            super()._wire_step(*a)

    ccfg = dataclasses.replace(cfg, wire_checkpoint_batches=MESH_CKPT_ROWS)
    tmp = tempfile.mkdtemp(prefix="mesh_ckpt_")
    try:
        path = os.path.join(tmp, "mesh.npz")
        crashing = Crashing(ConnectedComponents(), mesh)
        try:
            list(crashing.wire_records(EdgeStream.from_wire(rows, MESH_ROW, width, ccfg, device=dev), path))
            raise RuntimeError("(a): the injected crash did not fire")
        except MeshCrash:
            pass
        from gelly_streaming_tpu_torch.utils import checkpoint as ck

        resumed = MeshAggregationRunner(ConnectedComponents(), mesh)
        rstream = EdgeStream.from_wire(rows, MESH_ROW, width, ccfg, device=dev)
        like = resumed._wire_sharded_checkpoint_like(rstream, resumed._sharded_spec(ccfg), MESH_ROW)
        every = MESH_CKPT_ROWS // MESH_SHARDS
        if int(ck.load_state(path, like)["next_group"]) != every:
            raise RuntimeError(f"(a): the snapshot at the crash must say group {every}")
        recs, wall, counts, _ = mesh_main("(a) resume", lambda: list(resumed.wire_records(rstream, path)), need)
        same_labels("(a) resumed", recs, want)
        refolded = counts["comms"]["comms_dispatches"]
        if refolded != groups - every or counts["launches"]["ef40_unpack"] != (groups - every) * MESH_SHARDS:
            raise RuntimeError(f"(a): the resume must fold groups {every}..{groups - 1} alone: {counts}")
        out["checkpoint_resume"] = {**mesh_log(f"resume from the snapshot after group {every}", n, wall, counts),
                                    "groups_folded": refolded, "crashed_after_group": MESH_KILL_GROUP}
        log(f"    killed after group {MESH_KILL_GROUP}, resumed from the snapshot after group {every}: "
            f"{refolded} groups folded, none before it; labels equal phase 7's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def mesh_window_stream(seed: int = 21):
    """(b)'s stream: 16 windows of 2^15 uniform edges over 2^20 ids, half of
    window 5's sources one hub."""
    rng = np.random.default_rng(seed)
    n = MESH_WINDOWS * MESH_WIN_EDGES
    src = rng.integers(0, CC_VERTICES, n).astype(np.int32)
    dst = rng.integers(0, CC_VERTICES, n).astype(np.int32)
    h0 = MESH_HUB_WINDOW * MESH_WIN_EDGES
    src[h0 : h0 + MESH_WIN_EDGES // 2] = 123457
    return src, dst


def records_equal(label: str, got, want) -> None:
    import torch

    if len(got) != len(want):
        raise RuntimeError(f"{label}: {len(got)} records against {len(want)}")
    for (g,), (w,) in zip(got, want):
        for name in ("parent", "parent2", "seen"):
            if hasattr(w, name) and not torch.equal(getattr(g, name).cpu(), getattr(w, name).cpu()):
                raise RuntimeError(f"{label}: a record's {name} differs from the single-partition run's")
        if isinstance(w, torch.Tensor) and not torch.equal(g.cpu(), w.cpu()):
            raise RuntimeError(f"{label}: a record differs from the single-partition run's")


def phase_mesh_windows(dev) -> dict:
    """(b) the windowed owner-sharded plane (delta regime) and the
    replicated bipartiteness check, against single-partition runs."""
    from gelly_streaming_tpu_torch.core.aggregation import MeshAggregationRunner
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library.bipartiteness import BipartitenessCheck
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents
    from gelly_streaming_tpu_torch.library.degree_distribution import DegreeDistributionSummary
    from gelly_streaming_tpu_torch.parallel import mesh as pm

    src, dst = mesh_window_stream()
    n = len(src)
    mesh = pm.make_mesh(MESH_SHARDS, [dev] * MESH_SHARDS)
    base = StreamConfig(vertex_capacity=CC_VERTICES, batch_size=MESH_WIN_EDGES, num_shards=MESH_SHARDS,
                        ingest_window_edges=MESH_WIN_EDGES)
    out = {}
    for name, make, kw, need in (
            ("cc", ConnectedComponents, {}, ("owner_pack", "block_delta_fold", "union_kernel")),
            ("degree", DegreeDistributionSummary, {"binned_ingest": 1}, ("owner_pack", "degree_fold"))):
        cfg = dataclasses.replace(base, **kw)
        single = EdgeStream.from_arrays(src, dst, dataclasses.replace(cfg, num_shards=1), device=dev)
        want = single.aggregate(make()).collect()
        runner = MeshAggregationRunner(make(), mesh)
        stream = EdgeStream.from_arrays(src, dst, cfg, device=dev)
        got, wall, counts, busy = mesh_main(f"(b) {name}", lambda: runner.run(stream).collect(), need,
                                            profile=name == "cc")
        records_equal(f"(b) {name}", got, want)
        regimes = mesh_regimes(runner)
        if not any(k.startswith("delta") for k in regimes):
            raise RuntimeError(f"(b) {name}: no exchange took the delta regime: {regimes}")
        out[name] = {**mesh_log(f"{name} owner-sharded, {len(got)} windows", n, wall, counts, busy),
                     "regimes": regimes}
        log(f"    {name}: every record equals the single-partition run's; exchanges by regime {regimes}")
    # the replicated plane: bipartiteness over a near-bipartite stream
    rng = np.random.default_rng(22)
    bs = (rng.integers(0, CC_VERTICES // 2, n) * 2).astype(np.int32)
    bd = (rng.integers(0, CC_VERTICES // 2, n) * 2 + 1).astype(np.int32)
    odd = rng.choice(n, 5, replace=False)
    bd[odd[odd >= 8 * MESH_WIN_EDGES]] = bs[odd[odd >= 8 * MESH_WIN_EDGES]] + 2  # even-even edges, later windows
    bcfg = dataclasses.replace(base, sharded_state=0)
    want = EdgeStream.from_arrays(bs, bd, dataclasses.replace(bcfg, num_shards=1), device=dev).aggregate(
        BipartitenessCheck()).collect()
    runner = MeshAggregationRunner(BipartitenessCheck(), mesh)
    stream = EdgeStream.from_arrays(bs, bd, bcfg, device=dev)
    got, wall, counts, _ = mesh_main("(b) bipartiteness", lambda: runner.run(stream).collect(),
                                     ("parity_union_kernel", "slab_fold"))
    records_equal("(b) bipartiteness", got, want)
    verdicts = [bool(r[0].is_bipartite()) if hasattr(r[0], "is_bipartite") else None for r in got]
    out["bipartite"] = {**mesh_log(f"bipartiteness replicated, {len(got)} windows", n, wall, counts),
                        "bipartite_a_window": verdicts}
    log(f"    bipartiteness: every record equals the single-partition run's; verdicts {verdicts}")
    return out


def phase_mesh_routing(dev) -> dict:
    """(c) measurements routing on an explicit 8-shard shared mesh, against
    the same call on the CPU."""
    import torch

    from gelly_streaming_tpu_torch.examples import measurements as meas
    from gelly_streaming_tpu_torch.parallel import mesh as pm

    args = argparse.Namespace(shards=ROUTE_SHARDS, batch=ROUTE_PER_SHARD, capacity=ROUTE_CAP,
                              vertices=CC_VERTICES, alpha=1.3, seed=0, dev=dev)
    card, wall, counts, _ = mesh_main("(c) routing", lambda: meas.measure_routing(
        args, pm.make_mesh(ROUTE_SHARDS, [dev] * ROUTE_SHARDS)), ("owner_pack",))
    t0 = time.perf_counter()
    host = meas.measure_routing(args, pm.make_mesh(ROUTE_SHARDS, [torch.device("cpu")] * ROUTE_SHARDS))
    host_s = time.perf_counter() - t0
    if card != host:
        raise RuntimeError(f"(c): the card's routing measurement differs from the CPU's: {card} vs {host}")
    log(f"    {card}: equal to the CPU's ({host_s:.1f} s there); card {wall:.3f} s, launches {counts['launches']}")
    return {"result": card, "s": wall, "cpu_s": host_s, **counts}


def routing_cases(dev, rng) -> int:
    """(d) each routing kernel against its twin on the card: random inputs,
    every changed row in one owner with one slot, empty and all-DELTA_PAD
    buffers, 2^20 + 333 items (4,097 scan chunks: the carry's later
    passes and a partial chunk), each op, S in {2, 4, 8}.  Returns the
    count of mismatches."""
    import torch

    from gelly_streaming_tpu_torch.ops import routing as rk

    bad = 0

    def on(t):
        return None if t is None else t.to(dev)

    for s in (2, 4, 8):
        for n, cap, kind in ((1 << 16, 1 << 10, "random"), (4096, 1, "one_owner"), (777, 16, "empty"),
                             (1 << 14, 64, "owned"), ((1 << 20) + 333, 1 << 17, "owned")):
            live = {"random": rng.random(n) < 0.3, "one_owner": np.arange(n) % s == s - 1,
                    "empty": np.zeros(n, bool), "owned": rng.random(n) < 0.8}[kind]
            owner = torch.from_numpy(rng.integers(-1, s + 1, n).astype(np.int32)) if kind == "owned" else None
            a = torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32)) if kind == "owned" else None
            b = torch.from_numpy(rng.integers(-9, 1 << 20, n).astype(np.int32))
            acc_c, acc_g = torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32, device=dev)
            want = rk.owner_pack(torch.from_numpy(live), owner, a, b, s, cap, -1, 5, True, True, True, acc_c)
            got = rk.owner_pack(on(torch.from_numpy(live)), on(owner), on(a), on(b), s, cap, -1, 5, True, True,
                                True, acc_g)
            bad += sum(x is not None and not torch.equal(x, y.cpu()) for x, y in zip(want, got))
            bad += not torch.equal(acc_c, acc_g.cpu())
        rows_n, cap = 1 << 14, 512
        for op in ("min", "max", "add"):
            for pad_all in (False, True):
                blk = torch.from_numpy(rng.integers(-100, 100, rows_n).astype(np.int32))
                rr = [torch.from_numpy(np.full(cap, -1, np.int32) if pad_all else np.where(
                    rng.random(cap) < 0.2, -1, rng.integers(-rows_n - 2, rows_n + 2, cap)).astype(np.int32))
                      for _ in range(s)]
                vv = [torch.from_numpy(rng.integers(-1000, 1000, cap).astype(np.int32)) for _ in range(s)]
                want = rk.block_delta_fold(blk.clone(), rr, vv, op)
                got = rk.block_delta_fold(blk.to(dev), [on(r) for r in rr], [on(v) for v in vv], op)
                bad += not torch.equal(want, got.cpu())
            blk = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, 5003).astype(np.int32))
            slabs = [torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, 5003).astype(np.int32)) for _ in range(s)]
            fc, fg = torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32, device=dev)
            want = rk.slab_fold(blk.clone(), slabs, op, fc)
            got = rk.slab_fold(blk.to(dev), [on(x) for x in slabs], op, fg)
            bad += not torch.equal(want, got.cpu()) or (int(fc) > 0) != (int(fg) > 0)
    return bad


def phase_routing_kernels(dev, cpm) -> dict:
    """(d) the three kernels against their twins, then each timed on a held
    stream at (a)'s and (b)'s shapes beside its bound, its twin and the
    library call."""
    import torch

    from gelly_streaming_tpu_torch.ops import routing as rk

    rng = np.random.default_rng(23)
    bad = routing_cases(dev, rng)
    if bad:
        raise RuntimeError(f"(d): {bad} routing kernel outputs differ from their twins")
    log("    owner_pack, block_delta_fold and slab_fold equal their twins on every case (err 0)")
    c, s = CC_VERTICES, MESH_SHARDS
    r = c // s
    out = {}

    def same(x, y) -> bool:
        """Two outputs equal: tensors, or tuples of tensors and Nones."""
        if isinstance(x, torch.Tensor):
            return torch.equal(x.cpu(), y.cpu())
        if len(x) != len(y):
            return False
        return all(a is None and b is None or a is not None and b is not None and same(a, b) for a, b in zip(x, y))

    def timing(name, fn, twin, bound_ms, library=None, reps=20, checks=()):
        """Each of ``checks`` (label, kernel call, twin call, both on fresh
        copies of the timed inputs) must give equal outputs; then the
        kernel, its twin and the library call are timed."""
        for label, kern, plain in checks:
            if not same(kern(), plain()):
                raise RuntimeError(f"(d) {name}: {label}: the kernel differs from its twin at the timed shape")
        d_ms, h_us = device_ms(fn, reps, cpm)
        ms = cuda_ms(fn, reps)
        plain = cuda_ms(twin, 2, 1)
        lib = None if library is None else cuda_ms(library, reps)
        row = {"device_ms": d_ms, "host_us": h_us, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
               "ratio": d_ms / bound_ms, "library_ms": lib, "checked_equal": [c[0] for c in checks]}
        log(f"    {name}: device {d_ms:.5f} ms (host {h_us:.1f} us), events {ms:.5f} ms, twin {plain:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({d_ms / bound_ms:.2f}x)" + ("" if lib is None else f", library {lib:.5f} ms"))
        return row

    # owner_pack at (a): the dense exchange's count of changed rows (C rows,
    # about half changed), no slots
    live_a = torch.from_numpy(rng.random(c) < 0.5).to(dev)
    acc = torch.zeros(3, dtype=torch.int32, device=dev)

    def pack_with_acc(pack, *args, **kw):
        fresh = torch.zeros(3, dtype=torch.int32, device=dev)
        return (*pack(*args, **kw, acc=fresh), fresh)

    out["owner_pack_a"] = timing(
        "owner_pack at (a): count of C rows by owner",
        lambda: rk.owner_pack(live_a, None, None, None, s, 0, acc=acc),
        lambda: rk.owner_pack_plain(live_a, None, None, None, s, 0, acc=acc),
        c / HBM_BYTES_PER_S * 1e3,
        checks=[("counts and acc over 4,096 scan chunks",
                 lambda: pack_with_acc(rk.owner_pack, live_a, None, None, None, s, 0),
                 lambda: pack_with_acc(rk.owner_pack_plain, live_a, None, None, None, s, 0))])
    # owner_pack at (b): a pane's changed roots (2^15 of C) into [S, 2^16]
    cap_b = 1 << 16
    live_b = torch.zeros(c, dtype=torch.bool)
    live_b[torch.from_numpy(rng.choice(c, MESH_WIN_EDGES, replace=False))] = True
    live_b = live_b.to(dev)
    vals = torch.from_numpy(rng.integers(0, c, c).astype(np.int32)).to(dev)
    k = int(live_b.sum())
    out["owner_pack_b"] = timing(
        "owner_pack at (b): a pane's changed rows into [S, 2^16]",
        lambda: rk.owner_pack(live_b, None, None, vals, s, cap_b, want_sent=True, acc=acc),
        lambda: rk.owner_pack_plain(live_b, None, None, vals, s, cap_b, want_sent=True, acc=acc),
        (c + 4 * k + 8 * s * cap_b + c) / HBM_BYTES_PER_S * 1e3,
        checks=[("slots, sent, counts and acc",
                 lambda: pack_with_acc(rk.owner_pack, live_b, None, None, vals, s, cap_b, want_sent=True),
                 lambda: pack_with_acc(rk.owner_pack_plain, live_b, None, None, vals, s, cap_b, want_sent=True))])
    # block_delta_fold at (b): S senders' [2^16] buffers, 2^13 live rows each
    blk = torch.from_numpy(rng.integers(0, c, r).astype(np.int32)).to(dev)
    live_slots = MESH_WIN_EDGES // s
    rr, vv = [], []
    for _ in range(s):
        rows = np.full(cap_b, -1, np.int32)
        rows[:live_slots] = np.sort(rng.choice(r, live_slots, replace=False))
        rr.append(torch.from_numpy(rows).to(dev))
        vv.append(torch.from_numpy(rng.integers(0, c, cap_b).astype(np.int32)).to(dev))
    idx = torch.cat([x[:live_slots] for x in rr]).long()
    vval = torch.cat([x[:live_slots] for x in vv])
    out["block_delta_fold_b"] = timing(
        "block_delta_fold at (b): 4 senders' [2^16] buffers into a [2^18] block",
        lambda: rk.block_delta_fold(blk, rr, vv, "min"),
        lambda: rk.block_delta_fold_plain(blk.clone(), rr, vv, "min"),
        (8 * s * cap_b + 8 * s * live_slots) / HBM_BYTES_PER_S * 1e3,
        library=lambda: blk.scatter_reduce_(0, idx, vval, "amin", include_self=True),
        checks=[(f"op {op}", lambda op=op: rk.block_delta_fold(blk.clone(), rr, vv, op),
                 lambda op=op: rk.block_delta_fold_plain(blk.clone(), rr, vv, op)) for op in rk.OPS])
    # slab_fold at (a): 4 received [2^18] slabs min-folded into a block
    sblk = torch.from_numpy(rng.integers(0, c, r).astype(np.int32)).to(dev)
    slabs = [torch.from_numpy(rng.integers(0, c, r).astype(np.int32)).to(dev) for _ in range(s)]
    recv = torch.stack(slabs)

    def slab_pair(fold, op):
        """(the folded block, whether the flag grew) from a fresh block."""
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        return fold(sblk.clone(), slabs, op, flag), (flag > 0)
    out["slab_fold_a"] = timing(
        "slab_fold at (a): 4 [2^18] slabs into a block",
        lambda: rk.slab_fold(sblk, slabs, "min"),
        lambda: rk.slab_fold_plain(sblk.clone(), slabs, "min"),
        (s + 2) * r * 4 / HBM_BYTES_PER_S * 1e3,
        library=lambda: torch.minimum(sblk, recv.amin(0)),
        checks=[(f"op {op} (aligned rows: the int4 path) and its flag", lambda op=op: slab_pair(rk.slab_fold, op),
                 lambda op=op: slab_pair(rk.slab_fold_plain, op)) for op in rk.OPS])
    out["err"] = 0
    return out


def phase_mesh(dev, cpm, data: dict) -> dict:
    """Phase 21: (a) the mesh wire fold, (b) the windowed owner-sharded
    plane, (c) the routing measurement, (d) the kernels against their
    twins and their times."""
    t0 = time.perf_counter()
    log(f"  (a) mesh wire streaming CC at the bench shape: {MESH_SHARDS} shards sharing the card, rows of {MESH_ROW}")
    a = phase_mesh_wire(dev, data)
    log(f"  (b) windowed owner-sharded plane: {MESH_WINDOWS} windows of {MESH_WIN_EDGES} edges over 2^20 ids, "
        f"{MESH_SHARDS} shared shards, window {MESH_HUB_WINDOW} half on one hub")
    b = phase_mesh_windows(dev)
    log(f"  (c) measurements routing on {ROUTE_SHARDS} shared shards, {ROUTE_PER_SHARD} edges a shard, "
        f"capacity {ROUTE_CAP}, alpha 1.3, seed 0")
    c = phase_mesh_routing(dev)
    log("  (d) owner_pack, block_delta_fold and slab_fold against their twins, and their times")
    d = phase_routing_kernels(dev, cpm)
    s = time.perf_counter() - t0
    log(f"  phase 21: {s:.1f} s")
    return {"a": a, "b": b, "c": c, "d": d, "s": s}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline-cu", default=None,
                        help="a pane_triangles.cu with the first slice's C interface, "
                             "timed in turns with the current kernels")
    parser.add_argument("--parent-degrees-cu", default=None,
                        help="degrees.cu of the commit before the degree_fold redesign (d65530e; its C interface): "
                             "its degree_fold is timed in turns with the current one")
    parser.add_argument("--parent-unionfind-cu", default=None,
                        help="unionfind.cu of the commit before the compress redesign (d65530e; its C interface): "
                             "its compress split, and its compress and union calls timed in turns with the current")
    parser.add_argument("--parent-sage-cu", default=None,
                        help="sage.cu of the commit before the fused layer (its gather-mean C interface): its "
                             "gather, then addmm and relu, timed in turns with sage_layer")
    parser.add_argument("--parent-sage-backward-cu", default=None,
                        help="sage.cu of the commit before the tensor-core backward (ece4aae; the same C interface): "
                             "its backward and its layer over the contexts timed in turns with the current ones")
    parser.add_argument("--parent-neighborhoods-cu", default=None,
                        help="neighborhoods.cu of the commit before the radix sort (its C interface): "
                             "torch.sort, then its count and scatter, timed in turns with build_buckets")
    parser.add_argument("--parent-exact-cu", default=None,
                        help="exact_triangles.cu of the commit before the parallel folds (5e8e61b; its C interface): "
                             "its block and trace folds timed in turns with the current ones in phase 15")
    parser.add_argument("--parent-csr-cu", default=None,
                        help="csr_triangles.cu of the commit before the lookup redesign (8ff7365; its three C calls "
                             "around neighborhoods.cu's radix sort): timed in turns with csr_triangles in phase 14 (d)")
    parser.add_argument("--parent-spmv-cu", default=None,
                        help="spmv.cu of the commit before the balanced PageRank (9717394; its C interface): its "
                             "pagerank_fixpoint timed in turns with the current one on phase 16 (b)'s windows")
    parser.add_argument("--parent-kcore-cu", default=None,
                        help="kcore.cu of the commit before the one-launch fixed point (a48e429; its C interface): "
                             "its per-bucket round and pane_cores timed in turns with the current on phase 16 (c)")
    parser.add_argument("--parent-spanner-cu", default=None,
                        help="spanner.cu of the commit before the exact pre-pass (c34004e; its C interface): its "
                             "admission timed in turns with the current one on phase 17 (a) and (b)")
    parser.add_argument("--parent-matching-cu", default=None,
                        help="matching.cu of the commit before the windowed rounds (5030d41; its C interface): its "
                             "one-thread scan timed in turns with the current one on phase 17 (d)'s last batches "
                             "and the evicting chain")
    parser.add_argument("--parent-sampler-cu", default=None,
                        help="sampled_triangles.cu of the commit before the host key chain (c34004e; its C "
                             "interface): its scan timed in turns with the current one on phase 17 (e)'s batches")
    parser.add_argument("--parent-sketches-cu", default=None,
                        help="sketches.cu of the commit before the one-launch tri_fold and the grouped closure "
                             "count (e057c38; its C interface): its tri_fold and closure count timed in turns with "
                             "the current ones in phase 18 (b), beside the split of its time (TRI_SPLIT) and the "
                             "design's variants (TRI_DESIGNS)")
    parser.add_argument("--parent-wire-decode-cu", default=None,
                        help="wire_decode.cu of the commit before the bdv_decode redesign (5985037; the same C "
                             "interface): its bdv_decode timed in turns with the current one in phase 19 (b), "
                             "beside the split of its time (BDV_SPLIT)")
    args = parser.parse_args(argv)
    parent_wire_cu = os.path.abspath(args.parent_wire_decode_cu) if args.parent_wire_decode_cu else None
    parent_sketches_cu = os.path.abspath(args.parent_sketches_cu) if args.parent_sketches_cu else None
    parent_sum_cu = {k: os.path.abspath(path) for k, path in (("spanner", args.parent_spanner_cu),
                                                               ("sampler", args.parent_sampler_cu),
                                                               ("matching", args.parent_matching_cu)) if path}
    parent_spmv_cu = {k: os.path.abspath(path) for k, path in (("spmv", args.parent_spmv_cu),
                                                                ("kcore", args.parent_kcore_cu)) if path}
    parent_csr_cu = os.path.abspath(args.parent_csr_cu) if args.parent_csr_cu else None
    parent_exact_cu = os.path.abspath(args.parent_exact_cu) if args.parent_exact_cu else None
    baseline_cu = os.path.abspath(args.baseline_cu) if args.baseline_cu else None
    parent_backward_cu = os.path.abspath(args.parent_sage_backward_cu) if args.parent_sage_backward_cu else None
    parent_cu = {k: os.path.abspath(path) for k, path in (("degrees", args.parent_degrees_cu),
                                                           ("unionfind", args.parent_unionfind_cu)) if path}
    parent_sage_cu = {k: os.path.abspath(path) for k, path in (("sage", args.parent_sage_cu),
                                                                ("neighborhoods", args.parent_neighborhoods_cu))
                      if path}
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    try:
        from gelly_streaming_tpu_torch.core.config import StreamConfig
        from gelly_streaming_tpu_torch.core.stream import EdgeStream
        from gelly_streaming_tpu_torch.core.windows import windowed_panes
        from gelly_streaming_tpu_torch.io.prefetch import upload
        from gelly_streaming_tpu_torch.library import triangles as tri
        from gelly_streaming_tpu_torch.ops import _cuda
        from gelly_streaming_tpu_torch.ops import csr_triangles as ct
        from gelly_streaming_tpu_torch.ops import dense_triangles as dt
        from gelly_streaming_tpu_torch.utils import native
        from gelly_streaming_tpu_torch.utils.metrics import WindowLatencyRecorder
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} numpy {np.__version__}")

    log("phase 1: build kernels")
    t0 = time.perf_counter()
    split_cu = split_sources(parent_cu["unionfind"], COMPRESS_SPLIT, "unionfind") if "unionfind" in parent_cu else {}
    fold_split_cu = (split_sources(str(_cuda.CSRC_DIR / "degrees.cu"), FOLD_SPLIT, "degrees_fold")
                     if "degrees" in parent_cu else {})
    bwd_split_cu = split_sources(str(_cuda.CSRC_DIR / "sage.cu"), BACKWARD_SPLIT, "sage") if parent_backward_cu else {}
    grid_split_cu = split_sources(str(_cuda.CSRC_DIR / "spmv.cu"), GRID_SPLIT, "spmv_grid")
    rank_split_cu = split_sources(str(_cuda.CSRC_DIR / "spmv.cu"), RANK_SPLIT, "spmv_rank")
    bdv_split_cu = ({**{f"5985037 {k}": v for k, v in split_sources(parent_wire_cu, BDV_SPLIT,
                                                                     "wire_decode_parent").items()},
                     **{f"current {k}": v for k, v in split_sources(str(_cuda.CSRC_DIR / "wire_decode.cu"),
                                                                    BDV_DESIGNS, "wire_decode").items()}}
                    if parent_wire_cu else {})
    sources = [*_cuda.SIGNATURES, *([baseline_cu] if baseline_cu else []), *parent_cu.values(), *split_cu.values(),
               *parent_sage_cu.values(), *([parent_backward_cu] if parent_backward_cu else []),
               *([parent_exact_cu] if parent_exact_cu else []), *parent_spmv_cu.values(), *parent_sum_cu.values(),
               *([parent_sketches_cu] if parent_sketches_cu else []), *([parent_wire_cu] if parent_wire_cu else []),
               probe_source()]
    sketch_variants, sketch_failed = {}, []
    split_failed = []

    def build_split():  # beside the main build; a variant that does not build is skipped
        try:
            _cuda.build_all([*bwd_split_cu.values(), *fold_split_cu.values(), *grid_split_cu.values(),
                             *rank_split_cu.values(), *bdv_split_cu.values()])
        except RuntimeError as e:
            split_failed.append(str(e).splitlines()[0])

    def build_sketch_variants():  # each that builds is timed, the others reported
        built_v, failed_v = build_variants(sketch_variant_sources(parent_sketches_cu))
        sketch_variants.update(built_v)
        sketch_failed.extend(failed_v)

    host_lib = []

    def build_host():  # the host ingest library (csrc/edge_parser.cpp), beside the kernels
        t_host = time.perf_counter()
        host_lib.append((native.load_ingest_lib(), time.perf_counter() - t_host))

    split_threads = [threading.Thread(target=fn) for fn in
                     (build_split, build_host, *([build_sketch_variants] if parent_sketches_cu else []))]
    for th in split_threads:
        th.start()
    built = _cuda.build_all(sources)
    for th in split_threads:
        th.join()
    if not host_lib or host_lib[0][0] is None:
        raise RuntimeError("the host ingest library (csrc/edge_parser.cpp) did not build")
    log(f"  host ingest library {native.SOURCE} built and loaded in {host_lib[0][1]:.2f} s")
    if split_failed:
        log(f"  split variants: {split_failed[0]} (those variants are skipped)")
    for failure in sketch_failed:
        log(f"  sketch variant skipped, it did not build: {failure}")
    log(f"  built {len(built)} sources in {time.perf_counter() - t0:.2f} s: {sorted(built)}")
    for src, res in built.items():
        if src not in _cuda.SIGNATURES:
            continue
        for line in res.log.splitlines():
            if "ptxas" in line:
                log(f"  {src}: {line.strip()}")

    rng = np.random.default_rng(0)
    log("phase 2: pane_adjacency vs plain twin")
    adj_err = phase_adjacency(dev, rng)
    log("phase 3: dense_triangles vs plain twin and numpy")
    tri_err = phase_dense(dev, rng)

    log("phase 4: main path, window_triangles on the card")
    itcase = [(1, 2, 100), (1, 3, 150), (3, 2, 200), (2, 4, 250), (3, 4, 300),
              (3, 5, 350), (4, 5, 400), (4, 6, 450), (6, 5, 500), (5, 7, 550),
              (6, 7, 600), (8, 6, 650), (7, 8, 700), (7, 9, 750), (8, 9, 800),
              (10, 8, 850), (9, 10, 900), (9, 11, 950), (10, 11, 1000)]
    golden = EdgeStream.from_collection(
        [(s, d, 0, t) for s, d, t in itcase], StreamConfig(vertex_capacity=16),
        batch_size=4, with_time=True, device=dev,
    )
    got = sorted(tri.window_triangles(golden, 400).collect())
    if got != [(2, 399), (2, 1199), (3, 799)]:
        raise RuntimeError(f"ITCase golden mismatch: {got}")
    log("  ITCase golden (2,399) (3,799) (2,1199): ok")

    stream, panes = main_path_stream(rng, dev)
    expected = [
        (plain_pane_count(s, d, dev), (w + 1) * WINDOW_MS - 1)
        for w, (s, d) in enumerate(panes)
    ]
    # warm the path (allocator, pinned pool) outside the counted run
    tri.window_triangles(stream, WINDOW_MS).collect()
    torch.cuda.synchronize()
    dt.reset_launches()
    ct.reset_launches()
    t0 = time.perf_counter()
    records = tri.window_triangles(stream, WINDOW_MS).collect()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {**dt.LAUNCHES, **ct.LAUNCHES}  # csr_triangles: the sparse window's CSR fallback
    if records != expected:
        raise RuntimeError(f"window counts differ:\n got {records}\n want {expected}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel was not launched on the main path: {launches}")
    n_edges = sum(len(p[0]) for p in panes)
    log(f"  {len(records)} windows exact vs plain twins; counts {[r[0] for r in records]}")
    log(f"  launches on the main path: {launches}")
    log(f"  window_triangles: {main_s * 1e3:.1f} ms for {len(panes)} windows, "
        f"{len(panes) / main_s:.1f} panes/s, {n_edges / main_s:.4g} edges/s")
    checked, e_adj, e_tri = check_windows(panes, dev)
    adj_err, tri_err = max(adj_err, e_adj), max(tri_err, e_tri)
    log(f"  {checked} dense windows: pane_adjacency, dense_triangles and pane_triangles "
        f"bit-equal to the twins ({len(panes) - checked} CSR window: csr_triangles, held against its twin in "
        f"phase 14)")

    # where a window's time goes: the host time plane (batches read back
    # and cut into panes), host pane prep, then upload + kernels + readback
    t0 = time.perf_counter()
    host_panes = list(windowed_panes(stream, WINDOW_MS))
    t_cut = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepared = [tri._pane_prepare((p.src, p.dst), dev) for p in host_panes]
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    for meta, arrays in prepared:
        tri._pane_triangle_finish(tri._pane_dispatch(meta, upload(arrays, dev)))
    t_dev = time.perf_counter() - t0
    log(f"  per window: pane cut {t_cut / len(panes) * 1e3:.3f} ms, host prep "
        f"{t_prep / len(panes) * 1e3:.3f} ms, upload+count+readback "
        f"{t_dev / len(panes) * 1e3:.3f} ms")

    rec, dev_rec = WindowLatencyRecorder(), WindowLatencyRecorder()
    t0 = time.perf_counter()
    counts = tri.pipelined_pane_counts(
        panes, recorder=rec, warmup=1, depth=4, device_recorder=dev_rec, device=dev
    )
    pipe_s = time.perf_counter() - t0
    if counts != [c for c, _ in expected]:
        raise RuntimeError(f"pipelined counts differ: {counts}")
    log(f"  pipelined_pane_counts depth=4: {len(panes) / pipe_s:.1f} panes/s, "
        f"{n_edges / pipe_s:.4g} edges/s, close->host p50 {rec.percentile(50):.3f} ms "
        f"p95 {rec.percentile(95):.3f} ms, close->device p50 {dev_rec.percentile(50):.3f} ms")

    log("phase 5: kernel times at the main path's shapes")
    cpm = sleep_cycles_per_ms()
    log(f"  torch.cuda._sleep: {cpm:.0f} cycles per ms")
    src0, dst0 = panes[0]
    num_vertices = int(max(src0.max(), dst0.max())) + 1
    k = dt.pane_k(num_vertices)
    w, n = dt.pack_pane(src0, dst0)
    words, nn = to_dev(dt.packed_host_arrays(w, n), dev)
    bits = dt.pane_adjacency(words, nn, k)
    total = int(dt.dense_triangles(bits)[0])
    adj_err = max(adj_err, word_err(bits, dt.pane_adjacency_plain(words, nn, k)))
    tri_err = max(tri_err, abs(total - int(dt.dense_triangles_plain(bits)[0])))
    if adj_err or tri_err:
        raise RuntimeError(f"kernels disagree with their twins: {adj_err}, {tri_err}")
    adj = dt.unpack_bits(bits)
    nnz = int(adj.sum())
    # the oriented count's work: for each edge i < j, 2 ops a column above
    # j, and the bytes of row j from word j/32 on
    deg_below = torch.triu(adj, 1).sum(0, dtype=torch.int64)
    cols = torch.arange(k, device=dev)
    oriented_ops = int((2 * deg_below * (k - 1 - cols)).sum())
    suffix_bytes = int((deg_below * 4 * (k // 32 - cols // 32)).sum())

    def adj_fn():
        return dt.pane_adjacency(words, nn, k)

    def tri_fn():
        return dt.dense_triangles(bits)

    def pane_fn():
        return dt.pane_triangles(words, nn, k)

    def submit_fn():
        return dt.pane_triangles_submit_packed(words, nn, num_vertices)

    timed = {}
    for name, fn in (("pane_adjacency", adj_fn), ("dense_triangles", tri_fn),
                     ("pane_triangles", pane_fn)):
        d_ms, h_us = device_ms(fn, TIMED_REPS, cpm)
        timed[name] = (cuda_ms(fn, TIMED_REPS), d_ms, h_us)
        log(f"  K={k} {name}: device {d_ms:.5f} ms, host enqueue {h_us:.2f} us/call, "
            f"back-to-back events {timed[name][0]:.5f} ms")
    # the main path's call: its pinned readback buffer is not held under a
    # stalled stream, so it is timed back to back only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_REPS):
        submit_fn()
    submit_us = (time.perf_counter() - t0) / TIMED_REPS * 1e6
    torch.cuda.synchronize()
    log(f"  K={k} pane_triangles_submit_packed (one C call + readback): host "
        f"{submit_us:.2f} us/call, back-to-back events {cuda_ms(submit_fn, TIMED_REPS):.5f} ms")
    adj_plain_ms = cuda_ms(lambda: dt.pane_adjacency_plain(words, nn, k), 10)
    tri_plain_ms = cuda_ms(lambda: dt.dense_triangles_plain(bits), 10)
    a8 = adj.to(torch.int8)

    def int_mm():
        return (torch._int_mm(a8, a8) * a8).sum(dtype=torch.int64)

    if int(int_mm()) != total:
        raise RuntimeError("the _int_mm yardstick disagrees with the kernel")
    lib_ms = cuda_ms(int_mm, 20)
    adj_bound = (int(n) * 4 + 4 + k * k // 8) / HBM_BYTES_PER_S * 1e3
    tri_bytes_ms = (k * k // 8 + 8) / HBM_BYTES_PER_S * 1e3
    tri_ops_ms = oriented_ops / INT8_OPS_PER_S * 1e3
    log(f"  pane K={k}, n={int(n)} words, nnz(A)={nnz}, total={total}, oriented ops "
        f"{oriented_ops} (all ordered pairs: 2*nnz*K = {2 * nnz * k}, "
        f"{2.0 * nnz * k / INT8_OPS_PER_S * 1e3:.6f} ms at the int8 peak), "
        f"row-j suffix bytes of the oriented count {suffix_bytes}")
    log(f"  plain twins: pane_adjacency {adj_plain_ms:.4f} ms, dense_triangles "
        f"{tri_plain_ms:.4f} ms; _int_mm yardstick {lib_ms:.4f} ms")
    dev_share = (timed["pane_triangles"][1] * launches["dense_triangles"]) / (main_s * 1e3)
    log(f"  the pane count's device time at K={k} x {launches['dense_triangles']} launches = "
        f"{dev_share * 100:.3f}% of window_triangles' wall time")
    try:
        rows = profiler_device_us(pane_fn, 20)
        if rows:
            for key, (us, calls) in sorted(rows.items(), key=lambda r: -r[1][0])[:6]:
                log(f"  torch.profiler: {us:.3f} us/call device time, {calls} calls: {key[:90]}")
        else:
            log("  torch.profiler: key_averages() shows no device time")
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")

    # other widths and skewed panes: (name, words, n, K)
    panes5 = [(f"K={k}", words, nn, k)]
    for kk in (8192, 16384):
        panes5.append((f"K={kk}", *to_dev(seeded_pane_words(rng, kk, PANE_EDGES), dev), kk))
    panes5.append(("star K=4096", *to_dev(edge_words(rng, 4096, *star_edges(rng, 4096)), dev), 4096))
    panes5.append(("Zipf K=4096", *to_dev(
        edge_words(rng, 4096, *zipf_edges(rng, 4096, PANE_EDGES)), dev), 4096))
    for name, wk, nk, kk in panes5[1:]:
        bk = dt.pane_adjacency(wk, nk, kk)
        a_ms, _ = device_ms(lambda: dt.pane_adjacency(wk, nk, kk), 50, cpm)
        t_ms, _ = device_ms(lambda: dt.dense_triangles(bk), 50, cpm)
        log(f"  {name}: device pane_adjacency {a_ms:.5f} ms, dense_triangles {t_ms:.5f} ms "
            f"(nnz {int(dt.unpack_bits(bk).sum())})")

    if baseline_cu:
        log(f"phase 5b: in turns with the baseline build {args.baseline_cu}")
        old_adj, old_tri = baseline_wrappers(load_baseline(baseline_cu))
        for label, wk, nk, kk in panes5:
            bk = dt.pane_adjacency(wk, nk, kk)
            if word_err(old_adj(wk, nk, kk), bk) or int(old_tri(bk)[0]) != int(dt.dense_triangles(bk)[0]):
                raise RuntimeError(f"baseline and current kernels disagree on {label}")
            pairs = {
                "pane_adjacency": (lambda: old_adj(wk, nk, kk), lambda: dt.pane_adjacency(wk, nk, kk)),
                "dense_triangles": (lambda: old_tri(bk), lambda: dt.dense_triangles(bk)),
            }
            for name, (old_fn, new_fn) in pairs.items():
                turns = []
                for tag, fn in (("baseline", old_fn), ("current", new_fn),
                                ("current", new_fn), ("baseline", old_fn)):
                    d_ms, h_us = device_ms(fn, TIMED_REPS, cpm)
                    turns.append((tag, d_ms, h_us, cuda_ms(fn, TIMED_REPS)))
                log(f"  {label} {name}: " + "; ".join(
                    f"{tag} device {d:.5f} ms host {h:.2f} us events {e:.5f} ms"
                    for tag, d, h, e in turns))

    log("phase 6: union-find kernels vs plain twin at 2^20 vertices")
    uf_err = phase_union(dev, rng)
    log("phase 7: main path, streaming CC over the EF40 wire replay on the card")
    data = cc_bench_stream()
    cc = phase_cc_main(dev, cpm, data)
    if split_cu:
        cc["parent_split"] = compress_split(
            dev, cpm, load_baseline(parent_cu["unionfind"], PARENT_SIGNATURES["unionfind"]),
            {part: load_baseline(path, PARENT_SIGNATURES["unionfind"]) for part, path in split_cu.items()})
    log("phase 8: property streams over the CC bench's stream on the card")
    props = phase_properties(dev, cpm, data)
    log("phase 9: degree distribution: the EF40 summary fold and the signed scan")
    dd = phase_degree_dist(dev, cpm, data)
    log("phase 10: bipartiteness over the EF40 replay, and the windowed path")
    bp = phase_bipartite(dev, cpm, data)
    log("phase 12: slice() and windowed GraphSAGE at F = 128 on the card")
    sg = phase_sage(dev, cpm, {k: load_baseline(path, PARENT_SIGNATURES[k]) for k, path in parent_sage_cu.items()})
    log("phase 13: GraphSAGE training at F = 128 on the card")
    tr = phase_train(dev, cpm, load_baseline(parent_backward_cu, PARENT_SIGNATURES["sage_backward"])
                     if parent_backward_cu else None, built["sage.cu"].log, bwd_split_cu)
    turned = {}
    if parent_cu:
        log(f"phase 11: in turns with the parent builds {sorted(parent_cu.values())}")
        turned = phase_turns(dev, cpm, parent_cu, fold_split_cu, dd, cc, bp)
    log("phase 14: the async window pipeline, the superbatch planes and csr_triangles on the card")
    asy = phase_async(dev, cpm, stream, host_panes, expected,
                      parent_csr_call(load_baseline(parent_csr_cu, PARENT_SIGNATURES["csr"])) if parent_csr_cu
                      else None)
    log("phase 15: the streaming ExactTriangleCount on the card")
    ex = phase_exact(dev, cpm, parent_exact_calls(load_baseline(parent_exact_cu, PARENT_SIGNATURES["exact"]))
                     if parent_exact_cu else None)
    log("phase 16: the SpMV core and its algorithms (SSSP, PageRank, k-core, iterative CC) on the card")
    wrap = {"spmv": parent_pagerank, "kcore": parent_kcore_round}
    fix_sig = {k: _cuda.SIGNATURES["spmv.cu"][k] for k in ("spmv_fixpoint_launch", "spmv_fixpoint_scratch_bytes")}
    rank_sig = {k: _cuda.SIGNATURES["spmv.cu"][k] for k in ("pagerank_fixpoint_launch", "pagerank_scratch_bytes")}
    sp = phase_spmv(dev, cpm, data, {k: wrap[k](load_baseline(path, PARENT_SIGNATURES[k]))
                                     for k, path in parent_spmv_cu.items()},
                    {} if split_failed else {grid: variant_spmv_fixpoint(load_baseline(path, fix_sig))
                                             for grid, path in grid_split_cu.items()},
                    {} if split_failed else {part: variant_pagerank(load_baseline(path, rank_sig))
                                             for part, path in rank_split_cu.items()})
    log("phase 17: the spanner, the weighted matching and the sampled triangle estimators on the card")
    wrap = {"spanner": parent_spanner_call, "sampler": parent_sampler_call, "matching": parent_matching_call}
    sm = phase_summaries(dev, cpm, {k: wrap[k](load_baseline(path, PARENT_SIGNATURES[k]))
                                    for k, path in parent_sum_cu.items()})
    log("phase 18: the fixed-state sketches (HLL, count-min, the min-hash triangle sample) on the card")
    sk = phase_sketches(dev, cpm, data, load_baseline(parent_sketches_cu, PARENT_SKETCH_SIGNATURES)
                        if parent_sketches_cu else None,
                        {label: load_baseline(path, PARENT_SKETCH_SIGNATURES if label.startswith("e057c38")
                                              else SKETCH_SIGNATURES) for label, path in sketch_variants.items()})

    log("phase 19: checkpoints, supervised recovery and the compressed ingest on the card")
    ck = phase_checkpoints(dev, cpm, data, load_baseline(parent_wire_cu, PARENT_WIRE_SIGNATURES) if parent_wire_cu
                           else None, {} if split_failed else {part: load_baseline(path, PARENT_WIRE_SIGNATURES)
                                                               for part, path in bdv_split_cu.items()})

    log("phase 20: the network edge source, the measurement programs and wire_unpack on the card")
    tw = phase_twenty(dev, cpm)
    log("phase 21: the mesh aggregation plane, shards sharing the card (no multi-GPU speed is measured)")
    mesh = phase_mesh(dev, cpm, data)

    kernels = [
        {
            "name": "pane_adjacency",
            "route": "cuda",
            "source": "gelly_streaming_tpu_torch/csrc/pane_triangles.cu",
            "replaces": "gelly_streaming_tpu/ops/pallas_triangles.py:134",
            "launches": launches["pane_adjacency"],
            "max_abs_err": adj_err,
            "ms": timed["pane_adjacency"][0],
            "device_ms": timed["pane_adjacency"][1],
            "host_us": timed["pane_adjacency"][2],
            "plain_ms": adj_plain_ms,
            "bound_ms": adj_bound,
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "dense_triangles",
            "route": "cuda",
            "source": "gelly_streaming_tpu_torch/csrc/pane_triangles.cu",
            "replaces": "gelly_streaming_tpu/ops/pallas_triangles.py:38",
            "launches": launches["dense_triangles"],
            "max_abs_err": tri_err,
            "ms": timed["dense_triangles"][0],
            "device_ms": timed["dense_triangles"][1],
            "host_us": timed["dense_triangles"][2],
            "plain_ms": tri_plain_ms,
            "bound_ms": max(tri_bytes_ms, tri_ops_ms),
            "bound_by": "operations" if tri_ops_ms >= tri_bytes_ms else "bytes",
            "library_ms": lib_ms,
        },
        {
            "name": "union_kernel",
            "route": "cuda",
            "source": "gelly_streaming_tpu_torch/csrc/unionfind.cu",
            "replaces": "gelly_streaming_tpu/ops/unionfind.py:59",
            "launches": cc["launches"]["union_kernel"],
            "max_abs_err": uf_err,
            "ms": cc["union_ms"],
            "device_ms": cc["held"]["union_kernel"][0],
            "host_us": cc["held"]["union_kernel"][1],
            "plain_ms": cc["union_plain_ms"],
            "bound_ms": cc["union_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "first_call_ms": cc["first_ms"],
            "late_call_ms": cc["late_ms"],
            "rounds": cc["rounds"],
            # the second path: ops/spmv.cc_fixpoint under IterativeConnectedComponents (phase 16 (d))
            "also_replaces": "gelly_streaming_tpu/ops/spmv.py:585 (cc_fixpoint)",
            "launches_iterative_cc": sp["iterative_cc"]["launches"],
            "iterative_cc": sp["iterative_cc"],
            **{f"turns_{b}": turned[f"CC_{b}"] for b in ("first", "late", "late_c_call") if f"CC_{b}" in turned},
        },
        {
            "name": "compress_kernel",
            "route": "cuda",
            "source": "gelly_streaming_tpu_torch/csrc/unionfind.cu",
            "replaces": "gelly_streaming_tpu/ops/unionfind.py:27",
            # the CC fold's and the parity fold's (each C call compresses first)
            "launches": cc["launches"]["compress_kernel"] + bp["compress_launches"],
            "max_abs_err": uf_err,
            "ms": cc["compress_ms"],
            "device_ms": cc["held"]["compress_kernel"][0],
            "host_us": cc["held"]["compress_kernel"][1],
            "plain_ms": cc["compress_plain_ms"],
            "bound_ms": cc["compress_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "parts_us": cc["compress_parts_us"],
            **({"parent_split": cc["parent_split"]} if "parent_split" in cc else {}),
            **{f"turns_{k[9:]}": v for k, v in turned.items() if k.startswith("compress_")},
        },
    ]

    def entry(name, source, replaces, r, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"gelly_streaming_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": r["launches"], "max_abs_err": r["err"], "ms": r["ms"],
                "device_ms": r["device_ms"], "host_us": r["host_us"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": library_ms}

    kernels += [
        {**entry("degree_trace", "degrees.cu", "gelly_streaming_tpu/core/stream.py:869", props),
         "call_ms": props["call_ms"]},
        {**entry("degree_fold", "degrees.cu", "gelly_streaming_tpu/library/degree_distribution.py:247", dd["fold"],
                 dd["fold"]["library_ms"]),
         **{k: dd["fold"][k] for k in ("hub_device_ms", "l2_reductions_per_s", "random_reductions_ms")},
         **{f"turns_{k[5:]}": v for k, v in turned.items() if k.startswith("fold_") and k != "fold_split"},
         **({"split_without": turned["fold_split"]} if "fold_split" in turned else {})},
        {**entry("degree_dist_scan", "degrees.cu", "gelly_streaming_tpu/library/degree_distribution.py:43",
                 dd["scan"]),
         **{k: dd["scan"][k] for k in ("batch_events", "sort_ms", "serial_ms", "cut_launches", "small",
                                       "events_per_s", "records_per_s")}},
        {**entry("parity_union_kernel", "unionfind.cu", "gelly_streaming_tpu/ops/unionfind.py:145", bp),
         "first_call_ms": bp["first_ms"], "late_call_ms": bp["late_ms"], "rounds": bp["rounds"],
         **{f"turns_{b}": turned[f"parity_{b}"] for b in ("first", "late") if f"parity_{b}" in turned}},
    ]
    kernels += [
        {**entry("build_buckets", "neighborhoods.cu", "gelly_streaming_tpu/ops/neighborhoods.py:55", sg["build"],
                 sg["build"]["torch_sort_ms"]),
         "library_call": "torch.sort(stable=True) of the int32 grouping keys",
         **{k: sg["build"][k] for k in ("call_ms", "call_host_ms", "sort_ms", "passes", "hub", "turns")
            if k in sg["build"]}},
        {**entry("sage_layer", "sage.cu", "gelly_streaming_tpu/library/graphsage.py:53", sg["layer"],
                 sg["layer"]["library_ms"]),
         "bound_by": sg["layer"]["bound_by"],
         "library_call": "embedding_bag(mode='mean') + addmm (no one call computes the layer)",
         **{k: sg["layer"][k] for k in ("chunked_err", "mean_rel_err", "stack_err", "oracle_err", "embedding_bag_ms",
                                        "addmm_ms", "hub", "turns", "widths_ms") if k in sg["layer"]},
         "windows_per_s": sg["windows_per_s"],
         "edges_per_s": sg["edges_per_s"], "embeddings_per_s": sg["embeddings_per_s"]},
        {**entry("sage_layer_backward", "sage.cu", "gelly_streaming_tpu/library/graphsage.py:396", tr["backward"],
                 tr["backward"]["library_ms"]),
         "bound_by": tr["backward"]["bound_by"],
         "library_call": "embedding_bag(mode='mean') + mm(A^T, dH) (no one call computes the gradient)",
         **{k: tr["backward"][k] for k in ("host_us_a_call", "ratio_to_bound", "dw_err", "db_err",
                                           "embedding_bag_ms", "mm_ms", "contexts", "split", "ptxas", "turns")
            if k in tr["backward"]},
         "train_bench": tr["bench"], "train_pane": tr["pane"]},
    ]
    csr, group = asy["csr"], asy["csr"]["shapes"]["group"]
    kernels.append({
        "name": "csr_triangles", "route": "cuda", "source": "gelly_streaming_tpu_torch/csrc/csr_triangles.cu",
        "replaces": "gelly_streaming_tpu/library/triangles.py:229",
        "also_replaces": "gelly_streaming_tpu/library/triangles.py:322",
        # the superbatch plane's run (phase 14 (c)); the sync path's CSR fallback in phase 4
        "launches": asy["sb_launches"], "launches_sync_csr": launches["csr_triangles"],
        "launches_hub": csr["hub_launches"], "max_abs_err": csr["err"], "ms": group["ms"],
        "device_ms": group["device_ms"], "host_us": group["host_us"], "plain_ms": group["plain_ms"],
        "bound_ms": group["bound_ms"], "bound_by": "bytes", "library_ms": csr["library_ms"],
        "library_call": "torch.sparse.sampled_addmm over the group's block-diagonal adjacency",
        "library_csr_window_ms": csr["library_csr_window_ms"],
        "shapes": {k: {kk: vv for kk, vv in v.items() if kk != "counts"} for k, v in csr["shapes"].items()},
        "planes": {k: asy[k] for k in ("bench", "wide", "wide_idle_pct", "tri_async", "tri_superbatch", "snapshot")},
    })
    for name, key, line, launches_key, plain_key, extra in (
            ("triangle_block", "a", 504, "launches", "plain_ms", {"emit_us": ex["emit_us"],
                                                                   "host_diff_us": ex["host_diff_us"], "b": ex["b"]}),
            ("triangle_trace", "c", 450, "trace_launches", "trace_plain_ms", {})):
        run = ex[key]
        kernels.append({
            "name": name, "route": "cuda", "source": "gelly_streaming_tpu_torch/csrc/exact_triangles.cu",
            "replaces": f"gelly_streaming_tpu/library/triangles.py:{line}", "launches": ex[launches_key],
            "max_abs_err": ex["err"], "ms": run["ms"], "device_ms": run["device_ms"], "host_us": run["host_us"],
            "plain_ms": ex[plain_key], "bound_ms": run["bound_ms"], "bound_by": "bytes", "library_ms": None,
            **{k: run[k] for k in ("edges_per_s", "records_per_s", "idle_pct", "paths", "split_us", "scratch_bytes",
                                   "late", "a_batch4", "a_late", "turns") if k in run}, **extra})
    no_call = "none: no one PyTorch call computes the loop"
    kernels += [
        {**entry("spmv_fixpoint", "spmv.cu", "gelly_streaming_tpu/ops/spmv.py:344", sp["sssp"]),
         "library_call": no_call, **{k: sp["sssp"][k] for k in ("edges_per_s", "windows", "forced_pull_ms",
                                                                 "forced_push_ms", "scipy_rel_err", "mode_s",
                                                                 "blocks", "grid_sync_us", "threshold_sweep")},
         "bench": sp["bench"]},
        {**entry("pagerank_fixpoint", "spmv.cu", "gelly_streaming_tpu/ops/spmv.py:513", sp["pagerank"]),
         "library_call": no_call + "; csr_spmv_yardstick, not the same function: torch.mv of the dst-sorted copy "
                                   "as a CSR tensor (cuSPARSE, f32 sums), one iteration's spread",
         **{k: sp["pagerank"][k] for k in ("rel_err", "ms_an_iteration", "edge_iterations_per_s", "windows",
                                            "blocks", "csr_spmv_yardstick", "split_without")}},
        {**entry("kcore_fixpoint", "kcore.cu", "gelly_streaming_tpu/library/kcore.py:107", sp["kcore"]),
         "also_replaces": "gelly_streaming_tpu/library/kcore.py:41 (_build_bucket_round with _h_index_rows)",
         "library_call": no_call,
         "timed": "window 0's whole fixed point in one launch from the degrees (bound: its rounds' bounds); "
                  "round_ms: a round, the mean over its rounds, each replayed from the estimates it started from",
         **{k: sp["kcore"][k] for k in ("round_ms", "round_bound_ms", "edges_per_s", "windows", "blocks",
                                         "grid_sync_us")}},
        {**entry("kcore_round", "kcore.cu", "gelly_streaming_tpu/library/kcore.py:41", sp["kcore_round"]),
         "library_call": no_call, "on_main_path": False,
         "side_route_launches": sp["kcore_round"]["side_route_launches"],
         "launched_by": "launches: windowed_kcore's run (the main path; the card takes kcore_fixpoint); "
                        "side_route_launches: pane_cores(..., round_fn=spmv.kcore_round) over phase 16 (c)'s "
                        "windows, one C call a bucket a round; max_abs_err: that route's cores against the twin's",
         "timed": "a round of window 0 (every bucket, one C call each), the mean over its rounds, each replayed "
                  "from the estimates it started from"},
    ]
    spn, mt, smp = sm["spanner"], sm["matching"]["uniform"], sm["sampler"]
    kernels += [
        {**entry("spanner_admit", "spanner.cu", "gelly_streaming_tpu/library/spanner.py:90", spn),
         "also_replaces": "gelly_streaming_tpu/library/spanner.py:63 (_within_k_prefilter)", "library_call": no_call,
         "timed": "(a)'s last batch, each call on its own copy of the table before it",
         **{k: spn[k] for k in ("edges_per_s", "ratio", "candidates", "survivors", "us_a_survivor",
                                "first_batch_device_ms", "first_batch_survivors", "first_batch_us_a_survivor",
                                "per_batch", "split_us", "stats", "spanner_edges", "idle_pct", "busy_ms",
                                "turns_late", "turns_batch0", "turns_path") if k in spn},
         "k3": sm["spanner_k3"], "combine": sm["combine"]},
        {**entry("matching_scan", "matching.cu", "gelly_streaming_tpu/library/matching.py:38", mt),
         "library_call": no_call, "timed": "(d)'s last uniform batch, each call on its own copy of the state",
         **{k: mt[k] for k in ("edges_per_s", "ratio", "serial_steps", "rounds", "window", "ns_an_edge", "admitted",
                               "rounds_a_batch", "records", "matched", "idle_pct", "busy_ms", "loops_in_turns",
                               "turns") if k in mt},
         "movielens": sm["matching"]["movielens"], "chain": sm["matching"]["chain"]},
        {**entry("sampler_scan", "sampled_triangles.cu", "gelly_streaming_tpu/library/sampled_triangles.py:56", smp),
         "bound_by": smp["bound_by"], "library_call": no_call,
         "timed": "(e)'s last batch, each call on its own copy of the state, its keys on the card already",
         "also_source": "gelly_streaming_tpu_torch/csrc/threefry_chain.c (the key chain, on the host)",
         **{k: smp[k] for k in ("edges_per_s", "ratio", "estimate", "coins", "split_us", "twin_s", "idle_pct",
                                "busy_ms", "op_host_us", "host_chain_ns_a_hash", "host_cpu", "chain_ahead_ms",
                                "keys_ready_while_card_busy", "batches", "turns_batches") if k in smp}},
    ]
    sketches_py = "gelly_streaming_tpu/summaries/sketches.py"
    kernels += [
        {**entry("hll_fold", "sketches.cu", f"{sketches_py}:112", sk["hll"], sk["hll"]["library_ms"]),
         "bound_by": sk["hll"]["bound_by"],
         "library_call": "Tensor.scatter_reduce_(0, idx, rank, 'amax') over both banks, registers and ranks "
                         "precomputed",
         "timed": "(a)'s last batch: HLLDegreeSummary.update's C call (three key families), each call on its own copy",
         **{k: sk["hll"][k] for k in ("edges_per_s", "ratio", "twin_s", "idle_pct", "busy_ms", "emissions",
                                       "rel_err", "card_cpu_gap", "batch0", "turns") if k in sk["hll"]}},
        {**entry("cm_fold", "sketches.cu", f"{sketches_py}:175", sk["cm"], sk["cm"]["library_ms"]),
         "bound_by": sk["cm"]["bound_by"],
         "library_call": "Tensor.index_add_ of ones at the precomputed flat columns of both endpoints' d rows",
         "timed": "(a)'s last batch: CountMinHeavyHitters.update's C call (src, then dst), each call on its own copy",
         **{k: sk["cm"][k] for k in ("edges_per_s", "ratio", "twin_s", "idle_pct", "busy_ms", "emissions",
                                      "rel_err", "batch0", "turns") if k in sk["cm"]}},
        {**entry("tri_fold", "sketches.cu", f"{sketches_py}:251", sk["tri"]), "bound_by": sk["tri"]["bound_by"],
         "also_replaces": f"{sketches_py}:239 (tri_merge); {sketches_py}:112 (hll_fold of the edge registers)",
         "library_call": no_call,
         "timed": "(b)'s last batch: SketchTriangleCount.update's C call, each call on its own copy; wide: (a)'s "
                  "last batch of 2^21 edges folded into the final sample",
         **{k: sk["tri"][k] for k in ("edges_per_s", "ratio", "twin_s", "idle_pct", "busy_ms", "emissions",
                                       "estimate", "exact_triangles", "rel_err", "occupied", "wide",
                                       "launches_a_call", "turns") if k in sk["tri"]}},
        {**entry("tri_sampled_closures", "sketches.cu", f"{sketches_py}:341", sk["closures"]),
         "bound_by": sk["closures"]["bound_by"], "library_call": no_call,
         "timed": "(b)'s final sample, once an emission on the main path",
         **{k: sk["closures"][k] for k in ("ratio", "closures_oracle", "valid_rows", "star", "launches_a_call",
                                            "turns") if k in sk["closures"]},
         "contracts": sk["contracts"], "phase_s": sk["s"]},
    ]
    dec = ck["decode"]
    kernels.append({
        **entry("bdv_decode", "wire_decode.cu", "gelly_streaming_tpu/ops/wire_decode.py:41", dec),
        "also_replaces": "gelly_streaming_tpu/ops/wire_decode.py:66 (decode_bdv)",
        "library_call": "none: no one PyTorch call computes the decode",
        "timed": "(b)'s last batch of 2^21 edges as BDV, on a held stream",
        "ratio": dec["ratio"], "payload_bytes": dec["payload_bytes"], "wire_bytes": dec["wire_bytes"],
        "checked_buffers": ck["c"]["buffers"],
        **({"turns": dec["turns"]} if "turns" in dec else {}),
        "checkpoints": ck["a"], "compressed_ingest": ck["b"], "phase_s": ck["s"]})
    kernels.append({
        **entry("ef40_unpack", "wire_decode.cu", "gelly_streaming_tpu/io/wire.py:197", cc["ef40"]),
        "library_call": "none: no one PyTorch call computes the unpack",
        "timed": "phase 7's last batch of 2^21 edges over 2^20 ids as EF40, on a held stream",
        "ratio": cc["ef40"]["ratio"], "checked_buffers": ck["c"]["ef40_buffers"]})
    un = tw["unpack"]["times"]
    kernels.append({
        **entry("wire_unpack", "wire_decode.cu", "gelly_streaming_tpu/io/wire.py:120",
                {**un["pair40_2^21"], "launches": tw["measurements"]["launches"], "err": 0}),
        "also_replaces": "gelly_streaming_tpu/io/wire.py:589 (unpack_edges at width 3)",
        "library_call": "none: no one PyTorch call unpacks 20-bit pairs or 3-byte ints; plain_ms is the twin, the widening torch ops",
        "timed": "a PAIR40 batch of 2^21 edges on a held stream; width_3 and measurement_default beside it",
        "ratio": un["pair40_2^21"]["ratio"], "width_3": un["3_2^21"], "measurement_default": un["pair40_2^16"],
        "widths_2_4_torch_ops": {k: v for k, v in un.items() if k.startswith("ops_")},
        "checked_buffers": tw["unpack"]["checked"], "network_source": tw["network"],
        "measurements": {k: v for k, v in tw["measurements"].items() if k != "launches"}})
    runs = [*mesh["a"].values(), *mesh["b"].values(), mesh["c"]]

    def mesh_launches(kernel):
        return sum(r["launches"].get(kernel, 0) for r in runs)

    for k in kernels:
        if k["name"] in ("union_kernel", "compress_kernel", "ef40_unpack", "parity_union_kernel", "degree_fold"):
            k["launches_phase_21"] = mesh_launches(k["name"])
    md = mesh["d"]
    for name, row, replaces, extra in (
            ("owner_pack", md["owner_pack_b"], "gelly_streaming_tpu/parallel/routing.py:347",
             {"also_replaces": "gelly_streaming_tpu/parallel/routing.py:138 (owner_rank + _exchange_by_owner)",
              "library_call": "none: no one PyTorch call computes the stable capped per-owner compaction",
              "timed": "(b)'s shape: 2^15 changed rows of C = 2^20 into [4, 2^16] slots, on a held stream",
              "count_only_a": md["owner_pack_a"]}),
            ("block_delta_fold", md["block_delta_fold_b"], "gelly_streaming_tpu/parallel/routing.py:426",
             {"library_call": "Tensor.scatter_reduce_(0, rows, vals, 'amin', include_self=True) over the live slots",
              "timed": "(b)'s shape: 4 senders' [2^16] buffers, 2^13 live slots each, into a [2^18] block"}),
            ("slab_fold", md["slab_fold_a"], "gelly_streaming_tpu/library/connected_components.py:245",
             {"also_replaces": "the elementwise reductions of lax.pmin / pmax / psum "
                               "(gelly_streaming_tpu/library/connected_components.py:463, :367, :818)",
              "library_call": "torch.minimum(block, recv.amin(0)) over the stacked slabs",
              "timed": "(a)'s shape: 4 received [2^18] slabs min-folded into a block",
              "mesh": {k: v for k, v in mesh.items() if k != "d"}})):
        kernels.append({
            "name": name, "route": "cuda", "source": "gelly_streaming_tpu_torch/csrc/routing.cu", "replaces": replaces,
            "launches": mesh_launches(name), "max_abs_err": md["err"], "ms": row["ms"], "device_ms": row["device_ms"],
            "host_us": row["host_us"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": row["library_ms"], "ratio": row["ratio"], "shards_share_one_card": True, **extra})
    log(f"  total smoke time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

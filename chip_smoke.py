#!/usr/bin/env python3
"""On-card smoke test of lux_tpu_torch: build, check and time the CUDA
kernels, then drive single-GPU PageRank (direct and routed), collaborative
filtering, SSSP, connected components, the spec workloads (bfs, kcore,
labelprop, triangles), the long and out-of-core runs (delta-stepping,
adaptive repartitioning, host-offload streaming, checkpoint/resume) and
the batched query service (--serve) through the apps, dynamic graphs
(lux_tpu_torch.mutate: churn, warm refresh, compaction, the plan cache),
the cold start and observability surface (the plan disk cache in the
apps, overlapped planning, the telemetry ring, --profile-dir, the flight
recorder's event log, which every phase of the smoke and every worker
process writes into one run directory under LUX_OBS_DIR), the bf16 and
weighted-edge forms of the scan, mx and spmv kernels (weighted SSSP on
the pull-until fused-mx path), the serving
fleet and a pod (serve/fleet: replica and pod workers as CUDA processes
on the card), live serving (serve/live: live replica workers as CUDA
processes taking writes, with standing queries), the autopilot
(serve/autopilot: the autoscaler over CUDA worker processes, the soaks,
the election drill), big graphs from disk (the native host I/O
library, a `.lux` file loaded by parts, the --sort-segments and
--compact-gather gather relayouts) and the distributed pull and push
engines, direct and routed (parallel/: ranks of torch.distributed that
share the card).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It takes no options: the main path is the repository's headline size,
RMAT scale 20, edge factor 16, seed 0, 10 iterations; for collaborative
filtering (K = 20) that is the rating graph bipartite_ratings(2^19, 2^19,
2^23): 2^20 vertices, 2^24 edges.

Phases, each printing one JSON line with its seconds:
  1. device   the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build    nvcc of the seven kernel sources, all in parallel, g++ of the
              native host I/O library and lux-convert beside them, then
              g++ of the native route colorer; seconds of each.
  3. kernels  spmv_blockcsr and mxscan_segmented against their plain
              PyTorch versions, at a small ragged shape and at the main
              path's shape, for sum/min/max in f32 and int32 (and bf16
              sum for the SpMV).  min/max/int32 must be bitwise equal;
              f32 sums of positive values within rtol 1e-5 (the kernels
              associate the sum in another order than the plain
              versions), and two calls bitwise equal.  Then each
              kernel's stress case, timed: the SpMV on the main layout's
              slot count with one vertex holding every slot, and the scan
              at 2^24 elements with one segment (a head at 0 only); their
              f32 sums within rtol 1e-5 of the same sums in float64 (the
              plain f32 versions round a 17 M-term sum themselves), the
              scan's min/max/int32 bitwise.  Each kernel's launches
              (grid, threads, shared-memory bytes).
  4. plan     the routed plans of the main graph, each family built once
              and reused below: expand, its pass-fused form, the fused
              (group) plan and its pass-fused form, and fused-mx (all
              through the cached planners the apps call, into a cache
              directory that phase 19 loads); for
              each its spaces, digits, kernel and step counts, seconds
              and threads, and the colorer's calls over all of them (the
              native one must have run).  The three chains (expand then
              expand-pf, fused then fused-pf, fused-mx) and the fused-pf
              plan of phase 22's post-compaction base, the
              --sort-segments fused-pf plan of phase 24 (RMAT 18) and the
              "min" fused-mx plan of phase 13b's weighted graph build at
              once, each in a process of its own, started after phase 3
              (and, in a seventh process of DIST_PLAN_THREADS colorer
              threads, waited for only at phase 25, every plan family of
              phase 25's routed legs: dist_plans);
              they share one plan cache, whose route memo
              (ops/route.build_route_memo) colours each permutation they
              have in common once (the expand half of the main graph's
              families, the group half of fused-mx and "min").
              The card works meanwhile: phases 17 and 9-14, which need of
              these plans only the expand chain's (loaded from the cache
              once that chain is done), run beside the builds, so their
              host-clock times are taken under that load; every kernel
              table timing (phases 3, 5, 7, 13b) and the CF runs run
              outside it.  Then this process waits for the rest
              (`wait_seconds`) and loads every family of the main graph
              from the cache.  The order of the run: 1-3, 17, 9-14, 4,
              5, 6, 13b, 7, 8, 16, 18, 19, cf_accuracy, 15, 20-24; the
              oracles of cf_accuracy and phases 15, 18 and 22 start after
              7, once the host's cores are free.
  5. routed   the four routed-pull kernels against their plain versions:
              lane_gather (u8/int32 indices, f32/bf16/int32 values, small
              row counts and the main path's (2^24/128, 128)),
              sublane_gather (d = 2, 4, 8 at a small and a 2^21-column
              shape), fused_pass_gather on every group of the main
              expand-pf plan (with each tile size's launch and the CTAs
              an SM holds), mxreduce_pass_gather on the main fused-mx
              plan's reduce group (sum/min/max, f32 and int32; its
              chunks, grid and the CTAs an SM holds) and, on the same
              values, a rank map whose one output block holds every
              tile.  Gathers and mx min/max/int32 bitwise, mx f32 sums
              within rtol 1e-5 of the same sums in float64 (the plain
              version's f32 index_add_ rounds a hub's sum in atomic
              order, near that tolerance itself).  Beside them the
              path-level yardsticks: the whole routed expand against
              index_select, and the fused-mx apply against index_select
              plus the mxscan segment sum (both held to float64 sums).
              Then one torch.profiler session traces the three-launch
              kernels' f32 sums at the main shapes and prints each
              launch's device time: spmv_blockcsr (fill, spans, fold),
              mxscan_segmented (tiles, carries, apply) and
              mxreduce_pass_gather (fill, chunks, fold; the fold's share).
  6. main     `apps.pagerank`, 10 iterations with -check, for --method
              pallas, --method mxscan, and --route-gather expand, the bare
              flag (must resolve to expand-pf), fused, fused-pf and
              fused-mx (mxscan wherever the reduce is not fused).  Each
              run: check_ranks 0 bad vertices, ranks within rtol 1e-4 of
              the float64 oracle (10 iterations of float32 accumulation
              over segments of up to ~1e5 edges), the launch counter of
              its kernel >= the iteration count (every counter is set to
              0 just before the run).  The expand modes' ranks must equal
              the direct mxscan run's bit for bit, fused-pf's fused's.
  7-8. cf_kernel, cf_plan, cf_main, cf_accuracy: collaborative
              filtering's kernel against its plain version, its routed
              plans, the app's runs and the libraries against a float64
              oracle.
  9. push_main `apps.sssp` at RMAT 20 / ef 16 from the vertex with the
              largest out-degree, with -check, under --method mxscan, scan
              and scatter and --route-gather expand-pf and expand (mxscan
              beside them; the plans of phase 4, not planned again).  Each
              run: GTEPS on the traversed edges, ms, iterations, dense
              rounds, traversed edges; its kernels launched at least once
              per dense round.  The five distance arrays bitwise equal,
              with equal iterations and traversed edges, and equal to a
              BFS of scipy.sparse.csgraph from the same start, computed in
              the spawned pool.
  10. cc_main `apps.components` under the same five modes, and the pull
              form (models/components.connected_components, mxscan) once;
              every label array bitwise equal, and equal to the max-label
              fixpoint that the pool iterates with np.maximum.at.  Then
              push_race: one dense round of each app (gather, relax,
              segmented min/max, apply) under scan, scatter and mxscan,
              timed on the converged state: the cuda winners of min/max.
  11. spec_main the spec workloads through `apps.run`, each run with
              -check, its launches, GTEPS, the memory estimate it printed
              and the card's peak memory: bfs on the main graph from the
              four largest out-degrees under mxscan, scatter, scan and
              --route-gather expand-pf (phase 4's plan), bitwise equal in
              distances, iterations, traversed edges and dense rounds, and
              equal to scipy's shortest paths; --engine pull once, equal.
              kcore on the symmetrized main graph under mxscan, equal to a
              host peel; at RMAT 16 mxscan, scatter, fused-mx and
              expand-pf (plans built once here), bitwise equal.  labelprop (8 labels, seed stride 16, 10 iterations)
              under auto and scatter, within rtol 2e-4, atol 1e-6 of a
              float64 oracle.  triangles on the symmetrized weighted RMAT
              15 graph (nv = 2^15, 1,024 bitset words) under mxscan and
              scatter, within check_triangles' tolerance of a bitset
              oracle.  The oracles run in the spawned pool.  Then
              spec_kernels: the slice's new kernel callers against their
              plain versions, timed: the scan kernel's int32 sum over
              k-core's layout (31.4 M slots, bitwise) and its f32 sum over
              triangle phase 2's weighted, destination-dependent values
              (against the same sum in float64); the mx kernel's int32 sum
              on the RMAT 16 fused-mx plan.
  12. sum_race one segmented sum of one pull iteration at RMAT 20 per
              method (scan, scatter, mxscan, mxsum): the PageRank f32 sum
              and the k-core int32 sum; integer sums bitwise equal, f32
              sums' error against float64 recorded (only methods within
              rtol 1e-5 may win).  The f32 winner is the cuda sum row of
              engine/methods.WINNERS, printed beside it.
  13. delta_main weighted SSSP (the main graph's edges, integer weights
              1..100) from its largest out-degree through `apps.sssp`:
              chaotic, --delta 25 and 100, and --delta 100 with
              --route-gather expand-pf (phase 4's plan); all bitwise equal
              and equal to scipy's Dijkstra (the pool).  Rounds, traversed
              edges, ms, GTEPS, launches; the scan kernel's int32 min at
              one dense round of the weighted layout against its plain
              version.
  13b. variants the bf16 and weighted-edge forms at the main path's
              shapes, each driven once through its entry point with every
              counter 0 just before: mxscan_segmented bf16 sum, min and max
              (ops/segment.segment_*_csc(method="mxscan") over the main pull
              layout's slots), spmv_blockcsr bf16 min and max (the main
              block-CSR; library: scatter_reduce_ amin/amax) and
              mxreduce_pass_gather bf16 sum on phase 4's main fused-mx plan
              and bf16 min on the weighted graph's "min" plan
              (ops/expand.apply_fused).  min/max bitwise their plain twins
              and the scatter reduce; bf16 scan sums within rtol / atol 2e-2
              of float64, the mx sums' f32 totals within rtol 1e-5; each
              timed (20 launches) beside its bound, its plain twin and its
              launches.  Then weighted SSSP (library.SSSP_WEIGHTED, inf 2^30)
              through engine/pull.run_pull_until on the "min" fused-mx plan
              (loaded from phase 4's cache) from the hub: an untimed run,
              then a timed one, bitwise phase 13's `apps.sssp --weighted`
              distances with 0 violations of check_distances; iterations,
              ms an iteration, GTEPS and every kernel's launches
              (mxreduce_pass_gather at least once an iteration).
  14. repart_main SSSP (from the lowest-numbered vertex of out-degree 1:
              a BFS with a sparse start) and components with -ng 4 on the
              card, static and --repartition-every 2 (threshold 1.05), and
              SSSP with --repartition-every 1, which must recut:
              equal to each other and to phase 9-10's oracles; each
              recut's window imbalance and that window's work under the
              new cuts; ms against the static run.
  15. stream_main PageRank (10 iterations) and components on RMAT 22
              through --stream-hbm-gib 0.3: PageRank within rtol 1e-4 of
              its float64 oracle (the pool), components bitwise the
              resident pull run, prefetch on and off bitwise; chunks a
              part, bytes an iteration, ms an iteration with prefetch on
              and off, the rate of a plain pinned copy of the same bytes
              and the link bound it gives, peak memory (at most the
              budget) beside the estimate; the scan kernel on one chunk whose first
              segment began in an earlier chunk (f32 sum against float64,
              int32 max bitwise).
  16. ckpt_main  runs cut and resumed from their checkpoints, bitwise the
              uninterrupted runs: PageRank --ckpt-every 5 (5, then 10),
              SSSP --delta 25 --ckpt-every 2 and components --ckpt-every
              2, each cut at half its rounds; the seconds a save takes and
              its bytes on disk.
  17. serve_main the batched query service on the main graph: `apps.sssp
              --serve --serve-queries 16 --serve-buckets 1,8,16 -check` and
              `apps.pagerank --serve -ni 10 --serve-queries 16
              --serve-buckets 1,8,16 -check` (64 queries before PR 19)
              (QPS, latency p50/p95/p99, batch occupancy, warm hit ratio,
              the estimate and the peak memory); every SSSP answer 0 at its
              source with no triangle-inequality violation, the first 8
              bitwise a scipy BFS from the same source and the first 4 PPR
              answers within rtol 1e-4 of the float64 oracle (both in the
              pool); then serve/benchmarks.measure_serving (SSSP, Q = 64,
              4 sequential Q = 1 queries, one batch: bench.py's serving
              row) under auto and scatter, and one batched iteration's
              gather, edge, reduce and apply timed under the plain scan and
              scatter.  Each run's peak device memory (less what the card
              held before it) must not exceed the batched estimate
              (utils/preflight.estimate_batched) of its method.  No kernel lies on this path: auto's mxscan falls
              back to the plain scan on (E, Q) values.
  18. mutate_main dynamic graphs (the reference's refresh row,
              bench.py:1130-1330) on the main graph at 8 parts stacked on
              the card: priors (PageRank's exact fixpoint, SSSP from the
              largest out-degree, components), a one-edge warm-up batch
              refreshed, the 1 % churn (k = ne / 200 deletes, then k
              inserts, default_rng(0)) applied as two batches; the three
              warm refreshes timed best of two (two runs bitwise equal);
              batched SSSP serving (Q = 16, scatter) through a
              WarmEngineCache holding the overlay and the scheduler;
              compaction (snapshot + plan-cache invalidation report);
              the cold legs (read_lux, the shard builds with the same
              cuts, the expand-pf plan through the cached planner built
              on an empty cache and loaded again, the cold runs).  The six
              timed refreshes' mutate.refresh recorder spans must agree
              with their measured seconds within 5 %.  Warm
              SSSP and components bitwise the cold ones, scipy's BFS and
              the max-label fixpoint of the merged graph (the pool builds
              it by position, independently of the delta-log); PageRank
              warm and cold within rtol 1e-4 of the float64 fixpoint, their
              ulp distance printed; the served answers bitwise the
              compacted graph's engine, the first 8 scipy's BFS.  Then a
              churn confined to one part (invalidated fraction 1/8, the
              warm cache rebuilds that part alone) and the routed refresh
              on the one-part layout with phase 4's expand-pf, fused-pf
              and fused-mx plans (expand-pf bitwise the direct refresh,
              the fused ones within 1e-6; three max-label overlay
              iterations under each bitwise the cold merged-graph step;
              each kernel's launches in one iteration equal with the
              overlay and without).  Last, the four kernels of the path on
              the overlay's inputs against their plain versions: the scan
              on tombstone-masked values, the mx kernel with tombstoned
              ranks in the middle of tiles (timed), and every tombstoned
              routed replay bitwise its run on the plain versions.
  19. cold_obs cold start and observability on the main graph (see
              cold_obs_main): `apps.pagerank --route-gather expand-pf -ni
              10 -check` twice on phase 4's plan cache (both load, ranks
              and launches phase 6's); run_pull_fixed_overlapped with a
              plan_async future (expand-pf hands over mid-run, bitwise the
              direct run; a fused-pf future finishes direct); the
              telemetry ring on PageRank and SSSP (bitwise no-op, equal
              launches, residuals against float64); `apps.pagerank
              --method pallas --profile-dir` in a subprocess (its
              xprof.kernels point against the counters and a CUDA-event
              time of the same work).
  20. fleet   the serving fleet (see fleet_main): two replica workers as
              CUDA processes through the launcher, apps sssp and ppr,
              buckets 1, 8, 64, the controller here, the main graph as a
              .lux snapshot.  Under auto the 16 serving sources of phase
              17: SSSP bitwise, PPR within rtol 1e-5 of phase 17's
              in-process answers; phase 18's compacted 1 %-churn snapshot
              published (mutate/compact.publish_to_fleet) under a 16-query
              burst: nothing shed, and then every answer bitwise a fresh
              engine on the snapshot.  Under scatter (SSSP) the
              worker_kill_mid_burst drill: the victim SIGKILLs itself at
              its 5th query and the survivor answers all 16, bitwise.
              measure_fleet_saturation at width 1 under scatter: QPS
              and p99 at the knee.  Every worker's peak device bytes.
  21. pod     run_pull_pod over two pod worker processes on the card, the
              main graph in 8 parts (4 each): PageRank (10 iterations),
              SSSP from 732873 and components under auto, each bitwise the
              single-process 8-part run; ms an iteration beside the
              single-process one; every member launched mxscan_segmented
              once a resident part an iteration, counted from its
              pod_build.  The scan kernel on the largest part of that
              8-part layout, on the edge values of each app's final state
              (PageRank f32 sum within rtol 1e-5 of float64, SSSP int32
              min and components int32 max bitwise), against its plain
              version.  Then obs_log: the span totals of the whole event log, which
              must hold plan.load, plan.build, pull.chunk, serve.dispatch,
              mutate.refresh, xprof.trace, fleet.start, fleet.worker.start
              and mutate.publish.
  22. live    live serving (see live_main): two live replica workers as
              CUDA processes (--live, a journal each, --delta-cap 10240,
              standing SSSP from 732873, components and PageRank on the
              fused-pf route from phase 4's plan cache) behind a
              LiveFleetController.  The mixed window: 8 churn batches of
              4,096 rows (2,048 deletes of live base edges, 2,048 random
              inserts) admitted while two closed-loop readers send SSSP
              over the 16 serving sources, a quarter bounded by the last
              acknowledged generation; the 6th batch overflows and
              escalates to a fleet compaction.  Write batches/s and
              rows/s, read QPS, staleness p50/p99 in generations, the
              compaction's seconds; 0 shed, 0 deaths, every bounded read
              at or above its bound, the answers after the compaction
              bitwise a fresh engine.  One refresh_fleet: standing SSSP
              and components bitwise scipy's BFS and the max-label
              fixpoint of the merged graph (regenerated in the pool) and
              across the replicas, PageRank within rtol 1e-4 of the
              float64 fixpoint and bitwise across them.  The live
              kernels: mxscan_segmented on the standing push round's
              int32 min and max (tombstones masked), bitwise its plain
              version, and the fused-pf replay (fused_pass_gather,
              lane_gather) of the standing ranks with the tombstones,
              bitwise the replay on the plain versions.  The kill drill:
              w1 SIGKILLs itself at worker.before_delta_ack of generation
              9; the survivor takes 9 and 10 and answers a 16-query
              burst; w1 relaunched from the compaction snapshot and its
              journal (replayed to 9) is caught up to 10; standing SSSP
              and components bitwise the survivor's and the oracles,
              PageRank bitwise the survivor's and within rtol 1e-4 of the
              float64 fixpoint of generation 10.  Refresh seconds by
              app (first, warm, after the relaunch), catch-up seconds,
              deaths, heartbeat stalls, each worker's peak bytes beside
              the estimate and its kernel launches.
  23. autopilot measure_autoscale on the main snapshot under scatter:
              one CUDA worker process, process_spawner CUDA workers for
              the autoscaler (min 1, max 2), fed phase 20's one-worker
              knee: a level at 0.5x, levels at 1.5x until it scales up,
              levels at 0.5x until it scales down (the same worker, after
              the cooldown); no query lost, the shed fraction inside the
              policy's budget.  The scaler is told each level's offered
              load: the gates check its arithmetic and the join and
              retire, not overload detection.  autopilot_soak and chaos_soak at seed 0
              (chaos_soak at 4 steps) with CUDA thread workers here;
              election_drill on the model checker's unfenced
              counterexample: 2 elections unfenced, 1 fenced.  No
              lux-launch-* directory of the launcher is left after it.
  24. disk_main big graphs from disk (see disk_main): the streamed phase's
              RMAT 22 / ef 16 graph (67.1 M edges) written once to a .lux
              file by the native counting sort; native against NumPy,
              each timed once and bitwise equal: the file's per-part
              range reads (pread against a copy out of the memory map),
              load_pull_shards at 8 parts, and on the main graph
              build_pull_shards and build_push_shards at 8 parts and
              build_blockcsr; PageRank (mxscan, 10 iterations, -file, -ng
              8) in four layouts (default, --sort-segments,
              --compact-gather, both): each within rtol 1e-4 of phase 15's
              float64 oracle, compact bitwise the default and both
              bitwise sorted, ms an iteration, GTEPS and peak device
              bytes; the scan kernel's f32 sum on part 0 of the sorted and
              of the compact layout against float64; SSSP and components
              at RMAT 20 with --compact-gather and with --sort-segments,
              bitwise phase 9-10's oracles, and the scan kernel's int32
              min on one dense round of the compact push layout, bitwise
              its plain version; --sort-segments --route-gather fused-pf
              PageRank at RMAT 18 on phase 4's plan within rtol 1e-4 of
              float64, then one iteration replayed with every lane_gather
              and fused_pass_gather launch held bitwise to its plain
              version.  The block-CSR of phase 3 (and of phase 6's pallas
              run) is the native fill.  Last, SSSP of the file at 8 parts
              (mxscan, from its hub): phase dist's NCCL push run's twin.
  25. dist    the distributed pull and push engines (see dist_main) as spawned rank
              processes on the card (parallel/spawn.run_ranks, each rank
              loading only its parts of phase 24's file): (a) NCCL, one
              rank with all 8 parts, allgather + mxscan PageRank bitwise
              phase 24's single-process -ng 8 run; (b) gloo, 2 ranks of 4
              parts, the collectives staged through pinned host buffers:
              allgather + mxscan bitwise the same run, ring and scatter
              (--method scatter) within rtol 1e-4 of its float64 oracle; (c)
              gloo, 2 ranks, --method pallas on the main graph at 2 parts
              within rtol 1e-4 of float64; (d) gloo, 2 ranks,
              apps.colfilter --distributed --method pallas -ng 2 -check on
              the 2-D kernel within 1e-4 of phase 8's single-process
              pallas run, then the CF library on the 2-D kernel at gamma
              1e-3 within 1e-4 of the float64 CF oracle.  Each run's ms an
              iteration and its split into compute, staging and
              collective (a further fenced run); each rank's launches
              (kernels 2, 1, 7 at least once a part an iteration); the
              block-CSR kernels held on each rank's part against float64,
              timed beside their plain versions and index_add_; no rank
              process left.  The distributed push inside the same two
              spawn groups, through apps.sssp / apps.components
              --distributed -check: (a) SSSP of phase 24's file at 8 parts
              on the NCCL rank (mxscan), bitwise phase 24's single-process
              run; (b) on the 2 gloo ranks at RMAT 20: SSSP allgather +
              mxscan at 4 parts, again under LUX_MERGE_MODE=tree,
              components over the allgather (mxscan) and over the ring
              (--method scatter), SSSP and
              components on the block-CSR kernel (--method pallas, 2
              parts), --weighted --delta 25 on delta_main's graph and
              --repartition-every 1 from repart_main's tail source (it
              must recut), each bitwise phase 9's, 10's, 13's or 14's
              single-process run in
              state, iterations and traversed edges; kernel 2 (mxscan) or
              1 (pallas) launched at least once a dense round in every
              rank; in each rank kernel 1's int32 min (SSSP) and max
              (components) on its push part and kernel 2's int32 min at a
              dense round held bitwise to their plain versions and timed
              beside them (and scatter_reduce_ for kernel 1).  The spec
              workloads' mesh drivers in the 2 gloo ranks, through
              `apps.run --distributed -ng 4 -check`: bfs from phase 11's
              sources (push mxscan, push over --exchange ring with
              --method scatter, --engine pull mxscan), kcore (mxscan, the
              symmetrized view) and labelprop (8 labels, stride 16, 10
              iterations); bfs and kcore bitwise phase 11's runs in
              distances or coreness, iterations, traversed edges and dense
              rounds, kernel 2 launched at least once a dense round or
              round in every rank (the ring runs none), labelprop within
              rtol 2e-4 / atol 1e-6 of its float64 oracle.  (e) gloo, 4
              ranks as a 2 x 2 grid: `apps.pagerank --edge-shards 2 -ng 2
              --method scan` (RMAT 20, 10 iterations) within rtol 1e-4 of
              float64, `apps.colfilter --feat-shards 2 -ng 2` over the
              allgather and the ring (CF 20, K = 20, the step at gamma
              1e-3) within 1e-4 of the float64 CF oracle, each with its
              ms an iteration and split on the lead rank.  The routed
              legs (--route-gather under --distributed; routed_legs), in
              the same two groups at RMAT 18 / ef 16 (a depth cut; CF at
              scale 18, K = 20), every plan loaded from phase 4's cache
              (a rank that builds one cold fails the leg): 2 ranks of 2
              parts, PageRank allgather expand-pf (kernel 5) and fused-mx
              (kernel 6; within rtol 1e-5 of rank 0's single-process
              fused-mx run over every part's plan), ring and scatter
              expand (kernel 3), SSSP allgather and components ring
              expand (kernel 3, the push's dense rounds); on the 2 x 2
              grid PageRank --edge-shards 2 and CF --feat-shards 2,
              expand (kernel 3).  Each leg bitwise its direct twin, run
              in the same rank processes on the same shard build (push:
              state, iterations and traversed edges); the leg's kernel
              launched at least once an iteration (a dense round) in
              every rank, then held on that rank's plan slice against
              its plain version (the mx sum against float64) and timed
              beside it (and torch.gather for kernel 3); each leg's ms an
              iteration and split.  NCCL across cards is not exercised
              (one card).
Times: kernel, plain, one PyTorch library call where one computes the
same function, and the bound: the bytes the function must move over the
card's memory rate (every kernel here does at most one add or compare
per 4 bytes moved, so its operation time is far below it).
Then the kernel table as one JSON line (each row's launches on the
PageRank main path, and beside them on the push paths: one SSSP and one
components run of the mode that runs that kernel, on the spec paths
one bfs, one kcore and one triangles run, and on the long runs one delta,
one adaptive SSSP, one streamed PageRank and one resumed PageRank run,
on the serving path the whole of phase 17, on the dynamic-graph path
phase 18 up to the kernels' comparisons, the whole of phase 19, and in
the fleet and pod worker processes of phases 20-21, which each report
their own counters: ``launches_fleet``; in the live worker processes of
phase 22, the killed one's last report included: ``launches_live``; the
soaks of phase 23: ``launches_autopilot``; phase 24's runs:
``launches_disk``; phase 25's ranks, summed: ``launches_dist``; phase
13b's driven calls: ``launches_variants``, and
on rows 1, 2 and 6 ``variants``, the new forms' own records), the
smoke's seconds, the
nvidia-smi line, and the verdict line {"ok": true, "device": {...}}
last.  Any failed phase exits
non-zero before the verdict; so does a machine without a CUDA device.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import faulthandler
import functools
import gc
import glob
import json
import multiprocessing
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback

SCALE, EF, ITERS = 20, 16, 10  # the main path: RMAT 20 / ef 16, 10 iterations
REPS = 20  # timed launches per kernel
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SUM_RTOL = 1e-5
BF16_RTOL = BF16_ATOL = 2e-2  # bf16 sums (one rounding to bf16) against float64
RANK_RTOL = 1e-4
ROUTED = ("expand", "", "fused", "fused-pf", "fused-mx")  # "" = the bare flag
#: the kernel each main-path run must have launched >= ITERS times
RUN_KERNEL = {"pallas": "spmv_blockcsr", "mxscan": "mxscan_segmented",
              "expand": "lane_gather", "expand-pf": "fused_pass_gather",
              "fused": "lane_gather", "fused-pf": "fused_pass_gather",
              "fused-mx": "mxreduce_pass_gather"}
CF_K = 20  # latent features (models/colfilter.K)
CF_ROUTED_SCALE = 17  # the routed CF runs: two expand plans each
CF_GAMMA = 1e-3  # the accuracy runs' step (the app's 3.5e-7 barely moves)
CF_RTOL = 1e-4  # against the f64 oracle: 10 iterations of f32 sums
#: the kernel each CF run must have launched >= ITERS times
CF_RUN_KERNEL = {"pallas": "spmv_blockcsr_2d", "scatter": "segment_sum_sorted",
                 "expand-pf": "fused_pass_gather",
                 "expand": "lane_gather"}


#: the push apps' runs: (label, the app's extra flags, the phase-4 plan)
PUSH_RUNS = (("mxscan", ["--method", "mxscan"], None), ("scan", ["--method", "scan"], None),
             ("scatter", ["--method", "scatter"], None),
             ("expand-pf", ["--route-gather", "expand-pf", "--method", "mxscan"], "expand-pf"),
             ("expand", ["--route-gather", "expand", "--method", "mxscan"], "expand"))
#: the kernels each push run must launch, at least once per dense round
PUSH_RUN_KERNELS = {"mxscan": ("mxscan_segmented",),
                    "expand-pf": ("fused_pass_gather", "mxscan_segmented"),
                    "expand": ("lane_gather", "mxscan_segmented")}
#: the push run whose launches the kernel table gives for each kernel
PUSH_KERNEL_RUN = {"mxscan_segmented": "mxscan", "fused_pass_gather": "expand-pf",
                   "lane_gather": "expand"}
RACE = ("scan", "scatter", "mxscan")  # the dense round's segment-reduce methods
SUM_RACE = ("scan", "scatter", "mxscan", "mxsum")  # the sum's methods
SPEC_SOURCES = 4  # bfs: the largest out-degrees
#: bfs runs (label, the app's flags, whether it replays the phase-4 expand-pf plan)
BFS_RUNS = (("mxscan", ["--method", "mxscan"], False),
            ("scatter", ["--method", "scatter"], False),
            ("scan", ["--method", "scan"], False),
            ("expand-pf", ["--route-gather", "expand-pf", "--method", "mxscan"], True))
KCORE_ROUTED_SCALE = 16  # routed k-core: plans at RMAT 20 take minutes a family
KCORE_ROUTED = ("fused-mx", "expand-pf")
LP_LABELS, LP_STRIDE = 8, 16  # labelprop: the reference's defaults
LP_RTOL, LP_ATOL = 2e-4, 1e-6  # against the float64 oracle (tests/test_program.py:503)
TRI_SCALE = 15  # triangles: nv = TRIANGLES_MAX_NV, the reference's ceiling
#: per program, the run whose launches the kernel table gives for each kernel
SPEC_KERNEL_RUN = {
    "bfs": {"mxscan_segmented": "bfs-mxscan", "fused_pass_gather": "bfs-expand-pf",
            "lane_gather": "bfs-expand-pf"},
    "kcore": {"mxscan_segmented": "kcore-mxscan", "mxreduce_pass_gather": "kcore16-fused-mx",
              "fused_pass_gather": "kcore16-fused-mx", "lane_gather": "kcore16-expand-pf"},
    "triangles": {"mxscan_segmented": "triangles-mxscan"}}


#: the long and out-of-core runs (phases 13-16)
DELTA_WIDTHS = (25, 100)  # --delta widths: a quarter of the weight ceiling, and all of it
DELTA_ROUTED = 100  # the routed delta run's width
#: -ng, --repartition-every, and a tight --repartition-threshold, so that the
#: recut path runs at this size
REPART_PARTS, REPART_EVERY, REPART_THRESHOLD = 4, 2, 1.05
#: the streamed runs: RMAT 22 through a 0.3 GiB budget (the vertex side
#: alone takes 0.24 GiB of it, so the edges move in ~35 chunks)
STREAM_SCALE, STREAM_GIB = 22, 0.3
STREAM_MIN_CHUNKS = 4  # every part must stream in at least this many chunks
CKPT_PR_EVERY, CKPT_DELTA_EVERY, CKPT_CC_EVERY = 5, 2, 2  # --ckpt-every
SERVE_Q = 64  # the serving row's batch (bench.py:918-921): Q = 64, one part
#: the queries of the two --serve app runs and of mutate_main's service (64
#: before PR 19, whose smoke cut their depth: host-bound, they grew most on
#: a slower host); measure_serving and serve_split keep SERVE_Q
SERVE_APP_Q = 16
SERVE_BUCKETS = "1,8,16"  # the warm Q buckets of the two app runs
SERVE_BFS = 8  # SSSP answers held to scipy's BFS
SERVE_PPR = 4  # PPR answers held to the float64 oracle
SERVE_METHODS = ("auto", "scatter")  # measure_serving's runs
F32_TINY = 1.1754944e-38  # below the smallest normal f32: subnormal rounding
#: per kernel, the long runs whose launches the kernel table gives
LONG_KERNEL_RUN = {
    "mxscan_segmented": {"delta": ("delta", f"delta-{DELTA_ROUTED}"),
                         "repart": ("repart", "sssp"), "stream": ("stream", "pagerank"),
                         "ckpt": ("ckpt", "pagerank")},
    "fused_pass_gather": {"delta": ("delta", f"delta-{DELTA_ROUTED}-expand-pf")},
    "lane_gather": {"delta": ("delta", f"delta-{DELTA_ROUTED}-expand-pf")}}


#: the process pool of the host oracles and the scratch directory of the
#: generated graphs and checkpoints, removed on every exit path
_POOL = None
_TMP = None
_T0 = time.perf_counter()
#: the last phase line printed (its phase, run and clock), for the messages
#: of a stopped run
_LAST = {"phase": None}
#: seconds after which the smoke stops itself, ahead of the 1,200 s that a
#: card run may take: every thread's stack on stderr, every process it
#: started killed, exit 124
DEADLINE_S = 1170.0
_TEARDOWN = threading.Lock()


class PhaseFailure(Exception):
    pass


class Stopped(BaseException):
    """SIGTERM, SIGINT or SIGHUP: unwinds main through every phase's
    teardown (not an Exception, so no phase's handler catches it)."""


#: [phase, seconds since the start of its last line] for each run of
#: consecutive lines of one phase, in order (the timeline line)
_SPANS = []


def emit(obj) -> None:
    if "phase" in obj:
        # seconds since the smoke started: the phases' place on its clock
        obj = {**obj, "at_s": round(time.perf_counter() - _T0, 3)}
        _LAST["phase"] = f"{obj['phase']} {obj.get('run', '')} at {obj['at_s']} s".replace(
            "  ", " ")
        if _SPANS and _SPANS[-1][0] == obj["phase"]:
            _SPANS[-1][1] = obj["at_s"]
        else:
            _SPANS.append([obj["phase"], obj["at_s"]])
    print(json.dumps(obj), flush=True)


def timeline() -> list:
    """Each phase's seconds: from the previous phase's last line to its own
    last line, in the order the phases ran (a phase whose lines come in
    two runs appears twice)."""
    out, prev = [], 0.0
    for name, end in _SPANS:
        out.append([name, round(end - prev, 3)])
        prev = end
    return out


def child_processes() -> list:
    """(pid, command line) of every live child of this process, from
    /proc; children that have exited are reaped."""
    me, out = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
            if int(fields[1]) != me:
                continue
            with open(f"/proc/{name}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except (OSError, IndexError, ValueError):
            continue
        if fields[0] == "Z":
            try:
                os.waitpid(int(name), os.WNOHANG)
            except ChildProcessError:
                pass
            continue
        out.append((int(name), cmd))
    return out


def kill_children() -> list:
    """SIGKILL every child of this process but multiprocessing's resource
    tracker (it must outlive the pool to unlink its semaphores; it is
    stopped last, by teardown), each worker that leads its own session
    (serve/fleet/launcher starts them so) with its whole process group,
    and reap them.  Returns their command lines."""
    killed = []
    for pid, cmd in child_processes():
        if "resource_tracker" in cmd:
            continue
        try:
            if os.getpgid(pid) == pid:
                os.killpg(pid, signal.SIGKILL)
            else:
                os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            continue
        killed.append((pid, cmd))
    deadline = time.monotonic() + 30.0
    for pid, _ in killed:
        while time.monotonic() < deadline:
            try:
                if os.waitpid(pid, os.WNOHANG)[0]:
                    break
            except ChildProcessError:
                break  # reaped by its own handle
            time.sleep(0.05)
    return [cmd for _, cmd in killed]


def teardown(finished: bool) -> None:
    """Stop everything the run started, on every exit path: the oracle
    pool (its idle workers leave at their sentinels when the run
    finished, else they are killed), any process still running (named on
    stderr), the scratch directory, and multiprocessing's resource
    tracker.  Nothing is left for the interpreter's own exit, which the
    caller skips."""
    global _POOL
    with _TEARDOWN:
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
                signal.signal(sig, signal.SIG_IGN)
        if _POOL is not None:
            _POOL.shutdown(wait=False, cancel_futures=True)
            _POOL = None
        if finished:
            # the pool's manager thread ends once its workers have
            deadline = time.monotonic() + 30.0
            for t in threading.enumerate():
                if t is not threading.current_thread() and not t.daemon:
                    t.join(max(0.0, deadline - time.monotonic()))
        left = kill_children()
        if left:
            print(f"chip_smoke: killed {len(left)} processes still running at the end: "
                  + "; ".join(c[:160] for c in left), file=sys.stderr, flush=True)
        if _TMP is not None:
            shutil.rmtree(_TMP, ignore_errors=True)
        # the pool's queues go, and their semaphores leave the tracker's
        # books; then the tracker, which exits at its pipe's end
        gc.collect()
        from multiprocessing import resource_tracker

        stop = getattr(resource_tracker._resource_tracker, "_stop", None)
        if stop is not None:
            stop()
        sys.stdout.flush()
        sys.stderr.flush()


def on_stop_signal(signum, frame) -> None:
    """The first SIGTERM, SIGINT or SIGHUP: every thread's stack on
    stderr, every child killed at once (a SIGKILL may follow), then
    Stopped unwinds main; later ones are ignored while it does."""
    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        signal.signal(sig, signal.SIG_IGN)
    name = signal.Signals(signum).name
    print(f"chip_smoke: {name} after {_LAST['phase']}, "
          f"{time.perf_counter() - _T0:.1f} s in; stacks:", file=sys.stderr, flush=True)
    faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
    kill_children()
    raise Stopped(name)


def start_watchdog() -> None:
    """A daemon thread that stops the run at DEADLINE_S: stacks on
    stderr, teardown, exit 124."""
    def watch():
        time.sleep(max(0.0, _T0 + DEADLINE_S - time.perf_counter()))
        print(f"chip_smoke: {DEADLINE_S:g} s passed, after {_LAST['phase']}; stacks:",
              file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        teardown(finished=False)
        os._exit(124)

    threading.Thread(target=watch, name="smoke-watchdog", daemon=True).start()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


def host_line(tmp: str) -> dict:
    """The host beside the card: its cores and load (a card's host may be
    shared), and the scratch directory's filesystem (the longest
    /proc/mounts entry that holds it) with the median milliseconds of 20
    fsync'd 4 KiB writes there, what a journal's durable write costs."""
    path, fs = os.path.realpath(tmp), "?"
    best = ""
    with open("/proc/mounts") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) > 2 and path.startswith(parts[1]) and len(parts[1]) > len(best):
                best, fs = parts[1], parts[2]
    probe, ms = os.path.join(tmp, "fsync_probe"), []
    for _ in range(20):
        t0 = time.perf_counter()
        with open(probe, "wb") as fh:
            fh.write(b"\0" * 4096)
            fh.flush()
            os.fsync(fh.fileno())
        ms.append((time.perf_counter() - t0) * 1e3)
    os.remove(probe)
    return {"cpus": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
            "loadavg": os.getloadavg(), "tmp": tmp, "tmp_mount": best, "tmp_fs": fs,
            "fsync_ms_p50": sorted(ms)[len(ms) // 2]}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, between
    CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def compare(torch, got, want, exact: bool, mask=None, what: str = "kernel") -> float:
    """Max abs difference; raises PhaseFailure past the tolerance."""
    if mask is not None:
        got, want = got[mask], want[mask]
    if exact:
        require(torch.equal(got, want), f"{what} differs from its plain version")
        return 0.0
    g64, w64 = got.double(), want.double()
    diff = (g64 - w64).abs()
    err = float(diff.max()) if got.numel() else 0.0
    bad = diff > SUM_RTOL * w64.abs()
    if bool(bad.any()):
        i = int(torch.argmax((diff / w64.abs().clamp_min(1e-300)) * bad))
        raise PhaseFailure(f"{what}: f32 sum outside rtol {SUM_RTOL} at {int(bad.sum())} "
                           f"places: max abs err {err}; worst at {i}: got {float(g64[i])}, "
                           f"want {float(w64[i])}")
    return err


def spmv_cases(torch, np, spmv, bc, dev, reps: int, timed: bool):
    """Every supported spmv case on one block-CSR layout; returns rows."""
    rng = np.random.default_rng(7)
    C, T = bc.e_dst_rel.shape
    e_dst = torch.from_numpy(bc.e_dst_rel).to(dev)
    cb = torch.from_numpy(bc.chunk_block).to(dev)
    cf = torch.from_numpy(bc.chunk_first).to(dev)
    nv_pad = bc.num_vblocks * bc.v_blk
    state_f = torch.from_numpy(rng.random(nv_pad, dtype=np.float32) + 0.01).to(dev)
    state_i = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, nv_pad, dtype=np.int64).astype(np.int32)).to(dev)
    e_src = torch.from_numpy(bc.e_src_pos).to(dev).long()
    flat_dst = torch.from_numpy(np.where(
        bc.e_dst_rel < bc.v_blk,
        bc.chunk_block[:, None].astype(np.int64) * bc.v_blk + bc.e_dst_rel,
        nv_pad).reshape(-1)).to(dev)
    rows = []
    for op, dtype in (("sum", torch.float32), ("sum", torch.bfloat16),
                      ("min", torch.float32), ("max", torch.float32),
                      ("min", torch.int32), ("max", torch.int32)):
        src = state_i if dtype == torch.int32 else state_f.to(dtype)
        vals = src[e_src].contiguous()

        def kernel():
            return spmv.spmv_blockcsr(vals, e_dst, cb, cf, op=op, v_blk=bc.v_blk,
                                      num_vblocks=bc.num_vblocks)

        def plain():
            return spmv.spmv_blockcsr_plain(vals, e_dst, cb, cf, op=op, v_blk=bc.v_blk,
                                            num_vblocks=bc.num_vblocks)

        exact = op != "sum"
        got = kernel()
        # sums: the same sums in float64; the plain version's f32 index_add_
        # rounds a hub's ~7e4 values in atomic order, itself near rtol 1e-5
        want = plain() if exact else torch.zeros(
            nv_pad + 1, dtype=torch.float64, device=dev).index_add_(
                0, flat_dst, vals.reshape(-1).double())[:nv_pad]
        torch.cuda.synchronize()
        what = f"spmv {op} {dtype}"
        err = compare(torch, got, want, exact, what=what)
        require(torch.equal(got, kernel()), f"{what}: two calls differ")
        row = {"op": op, "dtype": str(dtype).replace("torch.", ""),
               "shape": [C, T], "max_abs_err": err, "exact": exact}
        if timed:
            out_bytes = nv_pad * got.element_size()
            nbytes = C * T * (vals.element_size() + 4) + out_bytes
            library_ms = None
            if op == "sum":
                vflat = vals.reshape(-1).float() if dtype != torch.float32 else vals.reshape(-1)
                library_ms = time_ms(torch, lambda: torch.zeros(
                    nv_pad + 1, device=dev).index_add_(0, flat_dst, vflat), reps)
            row.update(kernel_ms=time_ms(torch, kernel, reps),
                       plain_ms=time_ms(torch, plain, max(2, reps // 4)),
                       library_ms=library_ms, bound_ms=bound_ms(nbytes),
                       bytes=nbytes)
        rows.append(row)
    return rows


def scan_cases(torch, np, scan, head, valid_end, invalid, values_f, dev,
               reps: int, timed: bool):
    """Every supported scan case on one (head, validity) geometry."""
    rng = np.random.default_rng(11)
    n = head.shape[0]
    vals_i = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)).to(dev)
    if valid_end is not None:
        mask = torch.arange(n, device=dev) < valid_end.item()
    else:
        mask = ~invalid
    rows = []
    for op, dtype in (("sum", torch.float32), ("min", torch.float32),
                      ("max", torch.float32), ("sum", torch.int32),
                      ("min", torch.int32), ("max", torch.int32)):
        vals = vals_i if dtype == torch.int32 else values_f

        def kernel():
            return scan.mxscan_segmented(vals, head, invalid, op=op, valid_end=valid_end)

        def plain():
            return scan.mxscan_segmented_plain(vals, head, invalid, op=op,
                                               valid_end=valid_end)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        exact = not (op == "sum" and dtype == torch.float32)
        what = f"scan {op} {dtype}"
        err = compare(torch, got, want, exact, mask, what=what)
        require(torch.equal(got, kernel()), f"{what}: two calls differ")
        row = {"op": op, "dtype": str(dtype).replace("torch.", ""), "n": n,
               "max_abs_err": err, "exact": exact}
        if timed:
            nbytes = n * (vals.element_size() + 1 + vals.element_size())
            row.update(kernel_ms=time_ms(torch, kernel, reps),
                       plain_ms=time_ms(torch, plain, max(2, reps // 4)),
                       library_ms=None, bound_ms=bound_ms(nbytes), bytes=nbytes)
        rows.append(row)
    return rows


def timed(rows, op="sum", dtype="float32"):
    """The timed row of ``op`` and ``dtype`` among a kernel's case rows."""
    return next(r for r in rows if "kernel_ms" in r and r["op"] == op
                and r["dtype"] == dtype)


def traced_splits(torch, groups: dict, reps: int = 5) -> dict:
    """Device milliseconds per call of each launch of several wrappers,
    from ONE torch.profiler session (a later session in this process came
    back with no device events).  ``groups`` maps a wrapper's label to
    (fn, parts), ``parts`` a launch's label to a substring of its
    kernel's name.  Each group's ``reps`` calls follow a marker kernel
    (torch.cuda._sleep's), so a launch counts for the group whose marker
    it follows, whatever names the groups share; None where the group's
    window holds no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn, _ in groups.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn, _ in groups.values():
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    windows = []
    for e in events:
        if "spin_kernel" in e.name:
            windows.append([])
        elif windows:
            windows[-1].append(e)
    if len(windows) != len(groups):
        windows = [[] for _ in groups]
    return {label: {part: sum(e.time_range.elapsed_us() for e in win if sub in e.name)
                    / 1e3 / reps if any(sub in e.name for e in win) else None
                    for part, sub in parts.items()}
            for (label, (_, parts)), win in zip(groups.items(), windows)}


def spmv_hub_case(torch, np, spmv, bc, dev, reps: int, main_ms: float):
    """spmv_blockcsr on the main layout's slot count with one vertex holding
    every slot (chunk_block and e_dst_rel all 0): a run the old one-warp
    design walked serially.  f32 sums against float64 sums (the plain
    version's f32 index_add_ rounds a 17 M-term sum in atomic order and is
    no yardstick there), then timed beside the main layout's time."""
    C, T = bc.e_dst_rel.shape
    rng = np.random.default_rng(19)
    vals = torch.from_numpy(rng.random((C, T), dtype=np.float32) + 0.01).to(dev)
    e_dst = torch.zeros((C, T), dtype=torch.int32, device=dev)
    cb = torch.zeros(C, dtype=torch.int32, device=dev)
    cf = torch.zeros(C, dtype=torch.int32, device=dev)
    cf[0] = 1
    kw = dict(op="sum", v_blk=bc.v_blk, num_vblocks=bc.num_vblocks)
    got = spmv.spmv_blockcsr(vals, e_dst, cb, cf, **kw)
    want = torch.zeros(got.shape, dtype=torch.float64, device=dev)
    want[0] = vals.double().sum()
    torch.cuda.synchronize()
    err = compare(torch, got, want, exact=False, what="spmv, one vertex holding every slot")
    require(torch.equal(got, spmv.spmv_blockcsr(vals, e_dst, cb, cf, **kw)),
            "spmv, one vertex holding every slot: two calls differ")
    kernel_ms = time_ms(torch, lambda: spmv.spmv_blockcsr(vals, e_dst, cb, cf, **kw), reps)
    nbytes = C * T * 8 + got.numel() * 4
    return {"shape": [C, T], "op": "sum", "dtype": "float32", "max_abs_err": err,
            "rtol_vs_f64": SUM_RTOL, "kernel_ms": kernel_ms,
            "plain_ms": time_ms(torch, lambda: spmv.spmv_blockcsr_plain(vals, e_dst, cb, cf, **kw),
                                max(2, reps // 4)),
            "bound_ms": bound_ms(nbytes), "bytes": nbytes, "main_ms": main_ms,
            "ratio_to_main": kernel_ms / main_ms}


def scan_one_segment_case(torch, np, scan, dev, reps: int, main_ms: float, n: int = 1 << 24):
    """mxscan_segmented at n = 2^24 elements with one segment (a head at 0
    only), so every tile's carry runs through all the tiles before it.
    min/max/int32 bitwise against the plain version; f32 sums of positive
    values within rtol 1e-5 of float64 prefix sums (a 16.7 M-term prefix in
    the plain f32 ladder is no yardstick); the f32 sum timed."""
    rng = np.random.default_rng(12)
    head = torch.zeros(n, dtype=torch.bool, device=dev)
    head[0] = True
    vals_f = torch.from_numpy(rng.random(n, dtype=np.float32) + 0.01).to(dev)
    vals_i = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)).to(dev)
    rows, timing = [], {}
    for op, vals in (("sum", vals_f), ("min", vals_f), ("max", vals_f), ("sum", vals_i),
                     ("min", vals_i), ("max", vals_i)):
        exact = not (op == "sum" and vals.dtype == torch.float32)
        got = scan.mxscan_segmented(vals, head, op=op)
        want = (scan.mxscan_segmented_plain(vals, head, op=op) if exact
                else torch.cumsum(vals.double(), 0))
        torch.cuda.synchronize()
        what = f"scan {op} {vals.dtype}, one segment over {n} elements"
        err = compare(torch, got, want, exact, what=what)
        require(torch.equal(got, scan.mxscan_segmented(vals, head, op=op)),
                f"{what}: two calls differ")
        del want
        rows.append({"op": op, "dtype": str(vals.dtype).replace("torch.", ""),
                     "max_abs_err": err, "exact": exact})
        if not exact:
            timing = {"kernel_ms": time_ms(torch, lambda: scan.mxscan_segmented(
                vals_f, head, op="sum"), reps)}
    nbytes = n * (4 + 1 + 4)
    return {"n": n, "heads": 1, "cases": rows, "rtol_vs_f64": SUM_RTOL,
            "max_abs_err": max(r["max_abs_err"] for r in rows), "bound_ms": bound_ms(nbytes),
            "bytes": nbytes, "main_ms": main_ms, **timing,
            "ratio_to_main": timing["kernel_ms"] / main_ms}


def ragged_graph(np, csc):
    """A small graph with the block-CSR corner cases: a ragged last block,
    a hub vertex spanning several chunks, empty vertex blocks, and an
    all-padding tail."""
    rng = np.random.default_rng(5)
    nv = 5000
    dst = np.concatenate([rng.integers(0, 1500, 20000), np.full(3000, 2100),
                          rng.integers(4000, nv, 700)])
    src = rng.integers(0, nv, dst.shape[0])
    return csc.from_edge_list(src, dst, nv)


def counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from lux_tpu_torch.ops import kernel_wrappers

    return kernel_wrappers()


#: phase 4's plan chains, each built in a process of its own
PLAN_CHAINS = (("expand", "expand-pf"), ("fused", "fused-pf"), ("fused-mx",))


def plan_family(sh, mode: str, plan_dir: str):
    """One routed plan family of the one-part layout ``sh`` through the
    cached planner (built, or loaded from ``plan_dir``)."""
    from lux_tpu_torch.ops import expand

    if mode.startswith("expand"):
        return expand.plan_expand_shards_cached(sh, cache_dir=plan_dir, pf=mode == "expand-pf")
    if mode == "fused-mx":
        return expand.plan_fused_shards_cached(sh, "sum", cache_dir=plan_dir, mx=True)
    return expand.plan_fused_shards_cached(sh, "sum", cache_dir=plan_dir, pf=mode == "fused-pf")


def plan_chain(tmp: str, plan_dir: str, chain):
    """Phase 4's plan chain ``chain`` (families in order) built into the
    plan cache in a process of its own, on the one-part layout of the
    main graph saved under ``tmp``.  Returns each family's timed_plan
    report and the colorer's calls (ops/route.COLOR_STATS)."""
    import numpy as np

    from lux_tpu_torch import native
    from lux_tpu_torch.graph import csc
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.ops import route, shuffle

    sh = build_pull_shards(load_saved_graph(np, csc, tmp, "main"), 1)
    route.reset_color_stats()
    reps = [timed_plan(native, shuffle, mode, lambda m=mode: plan_family(sh, m, plan_dir))[1]
            for mode in chain]
    return reps, dict(route.COLOR_STATS)


def timed_plan(native, shuffle, mode: str, build):
    """Run ``build()`` (a routed planner) and return (plan, report): its
    spaces, digits, kernel and step counts, seconds and the colorer's
    threads.  Builds run concurrently, so which colorer ran is counted
    over all of them by the caller (ops/route.COLOR_STATS)."""
    t0, c0 = time.perf_counter(), time.process_time()
    plan = build()
    seconds = time.perf_counter() - t0
    static, arrays = plan
    # cpu_seconds: this process's CPU time over the build, every thread's
    rep = {"mode": mode, "n": static.n, "n2": getattr(static, "n2", None),
           "seconds": seconds, "cpu_seconds": time.process_time() - c0, "arrays": len(arrays),
           "bytes": int(sum(a.nbytes for a in arrays)),
           "threads": native.route_threads()}
    for k in ("r1", "r2", "vr"):
        r = getattr(static, k, None)
        if r is not None:
            rep[k] = {"dims": list(r.dims), "kernels": shuffle.route_num_hbm_passes(r),
                      "steps": shuffle.route_num_arrays(r)}
    if getattr(static, "mx", None) is not None:
        rep["mx_steps"] = len(static.mx.steps)
    return plan, rep


def lane_cases(torch, np, shuffle, dev, main_idx, reps: int):
    """lane_gather against torch.gather: row counts from 1 to a part's
    16384 for every value/index type (every tile size the kernel picks),
    then the main path's shape with a real pass's indices (timed), and
    the three shapes of its callers, a real pass's first rows at a part's
    (16384, 128) and a bucket's (4096, 128), timed three ways in turns
    with torch.gather (lux_tpu_torch/tools/kernel_timing.lane_timing:
    back-to-back event time, a CUDA graph's device time, host enqueue
    microseconds)."""
    from lux_tpu_torch.tools import kernel_timing

    rng = np.random.default_rng(13)
    n_cases = 0
    for rows in (1, 2, 4, 1000, 4096, 16384):
        for idt in (torch.uint8, torch.int32):
            for dt in (torch.float32, torch.bfloat16, torch.int32):
                x = torch.from_numpy(rng.integers(-2**20, 2**20, (rows, 128))
                                     .astype(np.int32)).to(dev)
                x = x if dt == torch.int32 else x.to(dt)
                idx = torch.from_numpy(rng.integers(0, 128, (rows, 128))
                                       .astype(np.int32)).to(dev).to(idt)
                got = shuffle.lane_gather(x, idx)
                require(torch.equal(got, shuffle.lane_gather_plain(x, idx)),
                        f"lane_gather differs at rows={rows} {dt} {idt}")
                n_cases += 1
    x = torch.from_numpy(rng.random(main_idx.shape, dtype=np.float32)).to(dev)
    got = shuffle.lane_gather(x, main_idx)
    torch.cuda.synchronize()
    require(torch.equal(got, shuffle.lane_gather_plain(x, main_idx)),
            "lane_gather differs at the main shape")
    idx64 = main_idx.long()
    n = x.numel()
    row = {"cases": n_cases, "shape": list(x.shape), "idx": "uint8",
           "max_abs_err": 0.0,
           "kernel_ms": time_ms(torch, lambda: shuffle.lane_gather(x, main_idx), reps),
           "plain_ms": time_ms(torch, lambda: shuffle.lane_gather_plain(x, main_idx), reps),
           "library_ms": time_ms(torch, lambda: torch.gather(x, 1, idx64), reps),
           "bound_ms": bound_ms(n * (2 * 4 + 1)), "bytes": n * (2 * 4 + 1)}
    three = []
    for rows in (main_idx.shape[0], 16384, 4096):
        try:
            three.append(kernel_timing.lane_timing(x[:rows].contiguous(),
                                                   main_idx[:rows].contiguous()))
        except AssertionError as e:
            raise PhaseFailure(str(e)) from None
    row["timed_three_ways"] = three
    return row


def segsum_cases(torch, kernel_timing, layouts, dev) -> list:
    """The sorted-key sum kernel (segment_sum_sorted: the scatter method's
    float sum on the card) at the scatter method's three shapes, on the
    keys of real layouts and values drawn on the card from a seed: each
    held bitwise across two launches, within SUM_RTOL of a float64
    index_add_ (bf16 inputs within BF16_RTOL, also bitwise across two
    runs), and timed beside index_add_ (the library call) and its bound,
    with no other process on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    rows = []
    for label, keys, n, k in layouts:
        shape = (keys.numel(),) if k == 1 else (keys.numel(), k)
        vals = torch.rand(shape, generator=gen, device=dev) + 0.01
        try:
            rows.append({"case": label, **kernel_timing.segsum_case(vals, keys, n)})
        except AssertionError as e:
            raise PhaseFailure(str(e)) from None
        del vals
        torch.cuda.empty_cache()
    return rows


def sublane_cases(torch, np, shuffle, dev, reps: int):
    rng = np.random.default_rng(14)
    out = {"cases": []}
    for d in (2, 4, 8):
        for length in (1000, 1 << 21):
            x = torch.from_numpy(rng.random((d, length), dtype=np.float32)).to(dev)
            idx = torch.from_numpy(rng.integers(0, d, (d, length)).astype(np.uint8)).to(dev)
            got = shuffle.sublane_gather(x, idx)
            torch.cuda.synchronize()
            require(torch.equal(got, shuffle.sublane_gather_plain(x, idx)),
                    f"sublane_gather differs at d={d} L={length}")
            out["cases"].append([d, length])
    idx64 = idx.long()
    n = x.numel()
    out.update(shape=list(x.shape), max_abs_err=0.0,
               kernel_ms=time_ms(torch, lambda: shuffle.sublane_gather(x, idx), reps),
               plain_ms=time_ms(torch, lambda: shuffle.sublane_gather_plain(x, idx), reps),
               library_ms=time_ms(torch, lambda: torch.gather(x, 0, idx64), reps),
               bound_ms=bound_ms(n * (2 * 4 + 1)), bytes=n * (2 * 4 + 1))
    return out


def fused_cases(torch, np, shuffle, expand, plan_pf, dev, reps: int):
    """fused_pass_gather on every group of the main expand-pf plan, in
    replay order (each group's input is the previous group's output);
    with each tile size's launch and the CTAs one SM holds."""
    static, arrays = plan_pf
    r1a, _, r2a = expand.split_arrays(static, arrays)
    rng = np.random.default_rng(15)
    groups = []
    for name, rs, ra in (("r1", static.r1, r1a), ("r2", static.r2, r2a)):
        y = torch.from_numpy(rng.random(rs.n, dtype=np.float32)).to(dev)
        i = 0
        for g in rs.groups:
            y = shuffle._relayout(y, g.view, g.perm_axes).reshape(g.kshape)
            k = len(g.steps)
            idx = ra[i:i + k]
            got = shuffle.fused_pass_gather(y, idx, g)
            torch.cuda.synchronize()
            require(torch.equal(got, shuffle.fused_pass_gather_plain(y, idx, g)),
                    f"fused_pass_gather differs on {name} group {len(groups)}")
            n = y.numel()
            nbytes = n * (2 * 4 + k * idx[0].element_size())
            groups.append({
                "route": name, "steps": k, "block_rows": g.block_rows,
                "relayouts": sum(st.relayout is not None for st in g.steps),
                "kernel_ms": time_ms(torch, lambda: shuffle.fused_pass_gather(y, idx, g), reps),
                "plain_ms": time_ms(torch, lambda: shuffle.fused_pass_gather_plain(y, idx, g),
                                    max(2, reps // 4)),
                "bound_ms": bound_ms(nbytes), "bytes": nbytes})
            y, i = got.reshape(-1), i + k
    mean = {k: sum(g[k] for g in groups) / len(groups)
            for k in ("kernel_ms", "plain_ms", "bound_ms")}
    # the launch of each tile size (csrc/fused_pass_gather.cu): one CTA per
    # tile, a thread per 16-element unit up to 512, the f32 tile in shared
    # memory; __launch_bounds__(512, 2) holds two such CTAs on an SM
    launch = {f"block_rows={br}": {
        "ctas": static.r1.n // 128 // br, "threads": min(br * 128 // 16, 512),
        "smem_bytes": br * 128 * 4}
        for br in sorted({g["block_rows"] for g in groups})}
    return {"groups": groups, "launch": launch, "max_abs_err": 0.0, "library_ms": None, **mean}


def mx_sum_f64(torch, shuffle, y, idx, dst_rel, tile_block, g):
    """The mx group's sums in float64: the plain version's steps, then an
    index_add_ over flat ranks in float64 (the plain version itself sums
    floats in f32)."""
    z = shuffle._steps_plain(y, g.steps, idx).double()
    ranks = dst_rel.long()
    tile = torch.arange(z.shape[0], device=z.device) // g.block_rows
    flat = tile_block.long()[tile][:, None] * g.v_blk + ranks
    valid = ranks < g.v_blk
    out = torch.zeros(g.num_blocks * g.v_blk, dtype=torch.float64, device=z.device)
    return out.index_add_(0, flat[valid], z[valid])


def mx_cases(torch, np, shuffle, expand, plan_mx, dev, reps: int):
    """mxreduce_pass_gather on the main fused-mx plan's reduce group, for
    every op and value type, against its plain version.  Returns the
    record and the f32-sum call, to be traced."""
    static, arrays = plan_mx
    *_, mxa = expand.split_fused_arrays(static, arrays, static.weighted)
    mxg = static.mx
    k = len(mxg.steps)
    idx, dst_rel, tile_block = mxa[:k], mxa[k], mxa[k + 1]
    total = sum(c for _, c, _ in static.groups)
    rng = np.random.default_rng(16)
    n2 = static.n2
    xf = torch.from_numpy(rng.random(n2, dtype=np.float32) + 0.01).to(dev)
    xi = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n2, dtype=np.int64)
                          .astype(np.int32)).to(dev)
    rows, err, timed = [], 0.0, {}
    for op, x in (("sum", xf), ("min", xf), ("max", xf), ("sum", xi), ("min", xi),
                  ("max", xi)):
        g = dataclasses.replace(mxg, op=op)
        y = shuffle._relayout(x, g.view, g.perm_axes).reshape(g.kshape)
        exact = not (op == "sum" and x.dtype == torch.float32)
        got = shuffle.mxreduce_pass_gather(y, idx, dst_rel, tile_block, g)
        # f32 sums: the plain version in float64.  In f32 its index_add_
        # accumulates one rank's values in atomic order, and at RMAT 20's
        # largest in-degrees that order's own rounding nears rtol 1e-5
        want = (shuffle.mxreduce_pass_gather_plain(y, idx, dst_rel, tile_block, g) if exact
                else mx_sum_f64(torch, shuffle, y, idx, dst_rel, tile_block, g))
        torch.cuda.synchronize()
        e = compare(torch, got[:total], want[:total], exact, what=f"mx {op} {x.dtype}")
        err = max(err, e)
        rows.append({"op": op, "dtype": str(x.dtype).replace("torch.", ""),
                     "max_abs_err": e, "exact": exact})
        if not exact:
            timed = {
                "kernel_ms": time_ms(torch, lambda: shuffle.mxreduce_pass_gather(
                    y, idx, dst_rel, tile_block, g), reps),
                "plain_ms": time_ms(torch, lambda: shuffle.mxreduce_pass_gather_plain(
                    y, idx, dst_rel, tile_block, g), max(2, reps // 4))}
    nbytes = (n2 * (4 + k * idx[0].element_size() + dst_rel.element_size())
              + mxg.num_blocks * mxg.v_blk * 4)
    per_block = torch.bincount(tile_block.long(), minlength=mxg.num_blocks)
    g = dataclasses.replace(mxg, op="sum")
    y = shuffle._relayout(xf, g.view, g.perm_axes).reshape(g.kshape)
    # a larger hub on the same values and steps: one output block holds
    # every tile, each of its v_blk ranks spans n2 / v_blk elements
    pos = torch.arange(n2, device=dev)
    hub_rel = torch.where(dst_rel.reshape(-1) < mxg.v_blk, pos * mxg.v_blk // n2,
                          mxg.v_blk).to(dst_rel.dtype).reshape(dst_rel.shape)
    hub_tb = torch.zeros_like(tile_block)
    hub = dataclasses.replace(g, num_blocks=1)
    got = shuffle.mxreduce_pass_gather(y, idx, hub_rel, hub_tb, hub)
    # a rank here sums 2^18 values: held to float64 sums, whose own
    # rounding stays far below rtol 1e-5 (the plain version's f32 would not)
    want = mx_sum_f64(torch, shuffle, y, idx, hub_rel, hub_tb, hub)
    torch.cuda.synchronize()
    hub_err = compare(torch, got, want, exact=False, what="mx, one block holding every tile")
    return {"cases": rows, "n2": n2, "steps": k, "tile_rows": mxg.block_rows,
            "num_blocks": mxg.num_blocks, "v_blk": mxg.v_blk, "max_abs_err": max(err, hub_err),
            # the output blocks' sizes, which the chunked grid no longer follows
            "max_tiles_per_block": int(per_block.max()),
            "mean_tiles_per_block": float(per_block.float().mean()),
            "largest_block_share": float(per_block.max()) / tile_block.numel(),
            # a CTA of 512 threads per chunk, its values in shared memory,
            # then one CTA folds the chunks' summaries
            "launch": {"chunk_ctas": shuffle.mx_num_chunks(y.shape[0], mxg.block_rows),
                       "chunk_threads": 512, "chunk_smem_bytes": shuffle.MX_MAX_TILE_ELEMS * 4,
                       "fold_ctas": 1},
            "hub": {"largest_block_share": 1.0, "max_abs_err": hub_err,
                    "kernel_ms": time_ms(torch, lambda: shuffle.mxreduce_pass_gather(
                        y, idx, hub_rel, hub_tb, hub), reps),
                    "plain_ms": time_ms(torch, lambda: shuffle.mxreduce_pass_gather_plain(
                        y, idx, hub_rel, hub_tb, hub), max(2, reps // 4))},
            "library_ms": None, "bound_ms": bound_ms(nbytes), "bytes": nbytes,
            **timed}, functools.partial(shuffle.mxreduce_pass_gather, y, idx, dst_rel, tile_block, g)


def path_yardsticks(torch, np, expand, segment, sh, plans, dev, reps: int):
    """The whole routed expand against index_select of the same state,
    and the whole fused-mx apply against index_select + the mxscan
    segment sum: the routed replay's cost beside the direct path's.  Both
    f32 sums are held to the same sums in float64 (rtol 1e-5), not to
    each other: each associates a hub's ~10^5 values its own way."""
    rng = np.random.default_rng(17)
    full = torch.from_numpy(rng.random(sh.spec.gathered_size, dtype=np.float32)
                            + 0.01).to(dev)
    src_pos = torch.from_numpy(sh.arrays.src_pos[0]).to(dev)
    row_ptr = torch.from_numpy(sh.arrays.row_ptr[0]).to(dev)
    head = torch.from_numpy(sh.arrays.head_flag[0]).to(dev)
    m = int(sh.arrays.edge_mask[0].sum())
    out = {"direct_gather_ms": time_ms(torch, lambda: full.index_select(0, src_pos), reps)}
    want = full.index_select(0, src_pos)
    for mode in ("expand", "expand-pf"):
        st, arr = plans[mode]
        part = tuple(a[0] for a in arr)
        got = expand.apply_expand(full, st, part)
        torch.cuda.synchronize()
        require(torch.equal(got[:m], want[:m]), f"routed {mode} differs from index_select")
        out[f"{mode}_ms"] = time_ms(torch, lambda: expand.apply_expand(full, st, part), reps)

    def direct_sum():
        return segment.segment_sum_csc(full.index_select(0, src_pos), row_ptr, head,
                                       method="mxscan")

    def direct_sum_f64():
        """The same segment sums in float64 (a cumulative sum's differences),
        the reference both f32 paths are held to."""
        vals = full.double().index_select(0, src_pos)
        cs = torch.zeros(vals.numel() + 1, dtype=torch.float64, device=dev)
        torch.cumsum(vals, 0, out=cs[1:])
        rp = row_ptr.long()
        return cs[rp[1:]] - cs[rp[:-1]]

    st, arr = plans["fused-mx"]
    part = tuple(a[0] for a in arr)
    got = expand.apply_fused(full, st, part)
    want = direct_sum_f64()
    torch.cuda.synchronize()
    compare(torch, got, want, exact=False, what="the fused-mx apply against f64 segment sums")
    compare(torch, direct_sum(), want, exact=False,
            what="index_select + mxscan against f64 segment sums")
    out["fused-mx_ms"] = time_ms(torch, lambda: expand.apply_fused(full, st, part), reps)
    out["direct_gather_mxscan_ms"] = time_ms(torch, direct_sum, reps)
    return out


def share_push_layouts(sssp_app) -> None:
    """Build each push layout once.  The push apps (SSSP, components, the
    bfs program, delta-stepping) build the push layout of their graph on
    every run (apps/sssp.build_push_app_shards, seconds of host time at
    RMAT 20), and the smoke runs them tens of times on the same graph
    objects at the same part counts: a run gets the layout the last run
    on its graph, part count and gather relayouts built (host arrays that
    no run writes; the engines copy them to the card).  A recut's layout
    is built as before."""
    build = sssp_app.build_push_shards
    memo = []  # [(graph, parts, relayouts, layout)], the last two

    def shared(g, num_parts, cuts=None, **kw):
        if cuts is not None:
            return build(g, num_parts, cuts=cuts, **kw)
        key = (kw.get("sort_segments", False), kw.get("compact_gather", False))
        for hg, parts, k, sh in memo:
            if hg is g and parts == num_parts and k == key:
                return sh
        sh = build(g, num_parts, **kw)
        memo[:] = [(g, num_parts, key, sh)] + memo[:1]
        return sh

    sssp_app.build_push_shards = shared


def cf_argv(scale: int) -> list:
    """The CF app's flags at ``scale`` (edge factor EF, seed 0, ITERS, -check)."""
    return ["--rmat-scale", str(scale), "--rmat-ef", str(EF), "--seed", "0",
            "-ni", str(ITERS), "-check", "--device", "cuda"]


def cf_oracle_f64(scale: int):
    """The float64 numpy oracle of CF (models/colfilter.colfilter_reference)
    at gamma = CF_GAMMA on the app's rating graph of ``scale``; returns
    (state (nv, K) float64, its RMSE, seconds).  Runs in a spawned process
    while the card works: at scale 20 it takes minutes on the host."""
    import numpy as np
    from lux_tpu_torch.apps import common
    from lux_tpu_torch.models import colfilter as cf
    from lux_tpu_torch.utils.config import parse_args

    g = common.load_graph(parse_args(cf_argv(scale)), weighted=True, bipartite=True)
    t0 = time.perf_counter()
    v = cf.colfilter_reference(g, ITERS, gamma=CF_GAMMA, dtype=np.float64)
    return v, cf.rmse(g, v), time.perf_counter() - t0


def tail_start(np, g) -> int:
    """repart_main's SSSP source: the lowest-numbered vertex of out-degree
    1, whose BFS starts with tiny frontiers (sparse windows whose work is
    uneven across parts, so the recut runs)."""
    return int(np.flatnonzero(g.out_degrees() == 1)[0])


def push_oracles(scale: int):
    """The push apps' host oracles on the main graph: (the vertex with the
    largest out-degree, its unweighted BFS distances from
    scipy.sparse.csgraph with INF == nv, the max-label fixpoint of
    models/components.fixpoint_labels, seconds, and the BFS distances from
    ``tail_start``).  Runs in a spawned process while the card works."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models.components import fixpoint_labels

    g = generate.rmat(scale, EF, seed=0)
    t0 = time.perf_counter()
    start = int(np.argmax(g.out_degrees()))
    adj = csr_matrix((np.ones(g.ne), (g.col_idx, g.dst_of_edges())), shape=(g.nv, g.nv))
    d = shortest_path(adj, directed=True, unweighted=True, indices=[start, tail_start(np, g)])
    dist = np.where(np.isinf(d), g.nv, d).astype(np.int32)
    return start, dist[0], fixpoint_labels(g), time.perf_counter() - t0, dist[1]


def push_runs(np, app, phase: str, g, extra_argv: list, plans: dict, kernels: dict,
              smi: str, device: str = "cuda"):
    """One push app through its CLI body under each of PUSH_RUNS on the
    main graph ``g``, with -check; every launch counter set to 0 just before
    each run and read just after.  Requires -check to pass, each run's
    kernels to launch at least once per dense round, and every run's
    state, iterations and traversed edges to equal the mxscan run's.
    Returns ({label: result}, {label: launch counts})."""
    results, launches = {}, {}
    for label, extra, mode in PUSH_RUNS:
        argv = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0", "-check",
                "--device", device] + extra_argv + extra
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = app.run(argv, route=plans.get(mode), graph=g)
        counts = {name: fn.launches for name, fn in kernels.items()}
        results[label], launches[label] = res, counts
        emit({"phase": phase, "run": label, "argv": extra_argv + extra, "rc": res.rc,
              "method": res.method, "route_gather": res.route_gather, "iters": res.iters,
              "dense_rounds": res.dense_rounds, "traversed_edges": res.traversed,
              "gteps": res.gteps, "ms": res.seconds * 1e3,
              "wall_seconds": time.perf_counter() - t0, "launches": counts,
              "nv": g.nv, "ne": g.ne, "device": smi})
        require(res.rc == 0, f"{phase} {label}: -check failed")
        for name in PUSH_RUN_KERNELS.get(label, ()):
            require(counts[name] >= max(res.dense_rounds, 1),
                    f"{phase} {label}: {name} launched {counts[name]} times in "
                    f"{res.dense_rounds} dense rounds")
        first = results["mxscan"]
        require(np.array_equal(res.state, first.state),
                f"{phase} {label}: state differs from the mxscan run")
        require((res.iters, res.traversed) == (first.iters, first.traversed),
                f"{phase} {label}: (iterations, traversed) {(res.iters, res.traversed)} "
                f"differ from the mxscan run's {(first.iters, first.traversed)}")
    return results, launches


def push_race(torch, push, sh, apps, dev, reps: int) -> dict:
    """Milliseconds of one dense round (engine/push.dense_part_step: the
    gather, relax, segmented min/max and apply of every edge) per RACE
    method, for each (name, program, converged global state) of ``apps``
    on the pull layout ``sh``; the methods' outputs must be bitwise
    equal.  Returns {name: {method: ms}}."""
    from lux_tpu_torch.graph.shards import to_device

    arr = to_device(sh.arrays, dev).part(0)
    out = {}
    for name, prog, state in apps:
        full = prog.init_state(arr.global_vid, arr.degree, arr.vtx_mask)
        full[: state.shape[0]] = torch.from_numpy(state).to(dev)
        rounds = {m: push.dense_part_step(prog, arr, full, full, m) for m in RACE}
        for m in RACE:
            require(torch.equal(rounds[m], rounds["scan"]),
                    f"race {name}: the {m} dense round differs from scan's")
        out[name] = {m: time_ms(torch, functools.partial(push.dense_part_step, prog, arr,
                                                         full, full, m), reps)
                     for m in RACE}
    return out


def bfs_sources(np, g) -> list:
    """bfs's sources: the SPEC_SOURCES largest out-degrees (bench.py:747's choice)."""
    deg = np.bincount(g.col_idx, minlength=g.nv)
    return [int(v) for v in np.argsort(deg)[::-1][:SPEC_SOURCES]]


def spec_oracles_bfs_labelprop(scale: int):
    """The bfs and labelprop host oracles on the main graph (scipy: the
    unweighted shortest paths from each source, minimum over them; the
    float64 labelprop recurrence as CSR products) and their seconds.
    Runs in a spawned process while the card works."""
    import numpy as np
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.program import workloads as wl

    g = generate.rmat(scale, EF, seed=0)
    t0 = time.perf_counter()
    dist = wl.bfs_reference_fast(g, bfs_sources(np, g))
    t1 = time.perf_counter()
    probs = wl.labelprop_reference_fast(g, LP_LABELS, LP_STRIDE, ITERS)
    return dist, probs, {"bfs": t1 - t0, "labelprop": time.perf_counter() - t1}


def spec_oracles_kcore_triangles(scale: int, tri_scale: int):
    """The k-core host oracle on the symmetrized main graph (the peel by
    removed vertices' out-edges) and the triangle oracle on the
    symmetrized weighted graph of ``tri_scale`` (bitsets, per-edge set
    bits of the intersection), with their seconds.  Runs in a spawned
    process while the card works."""
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.program import workloads as wl

    gs = wl.symmetrize(generate.rmat(scale, EF, seed=0))
    t0 = time.perf_counter()
    core = wl.kcore_reference_fast(gs)
    t1 = time.perf_counter()
    gt = wl.symmetrize(generate.rmat(tri_scale, EF, seed=0, weighted=True))
    t2 = time.perf_counter()
    inc = wl.triangles_reference_fast(gt)
    return core, inc, {"kcore": t1 - t0, "triangles": time.perf_counter() - t2}


def spec_run(torch, run_app, phase: str, label: str, argv: list, kernels: dict,
             smi: str, graph, route=None):
    """One program through apps/run.py with its launch counters set to 0
    just before and read just after, and the card's peak memory of the
    run; emits its line and requires -check to pass.  Returns (result,
    launch counts)."""
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_app.run(argv, route=route, graph=graph)
    counts = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": phase, "run": label, "argv": argv, "rc": res.rc, "method": res.method,
          "route_gather": res.route_gather, "iters": res.iters, "gteps": res.gteps,
          "ms": res.seconds * 1e3, "wall_seconds": time.perf_counter() - t0,
          "stats": res.stats, "launches": counts, "estimate_bytes": res.estimate_bytes,
          "max_memory_allocated": peak, "nv": res.graph.nv, "ne": res.graph.ne,
          "device": smi})
    require(res.rc == 0, f"{phase} {label}: -check failed")
    return res, counts


def spec_kernel_cases(torch, np, scan, shuffle, expand, pull, wl, library, bind,
                      kcore_res, g_tri, plan_mx, dev, reps: int) -> list:
    """The slice's new callers of the kernels, at its shapes, against their
    plain versions: the scan kernel's int32 sum over k-core's symmetrized
    layout (the alive flags of level 2, gathered per edge), its f32 sum
    over triangle phase 2's weighted, destination-dependent edge values,
    and the mx kernel's int32 sum on routed k-core's fused-mx plan (0/1
    values in its group space)."""
    from lux_tpu_torch.graph.shards import build_pull_shards, to_device

    rows = []
    gs = kcore_res.graph
    sh = build_pull_shards(gs, 1)
    a = to_device(sh.arrays, dev).part(0)
    core = torch.from_numpy(kcore_res.state).to(dev)
    alive = torch.cat([(core >= 2).to(torch.int32), torch.zeros(
        sh.spec.nv_pad - gs.nv, dtype=torch.int32, device=dev)])
    rows.append(scan_case(torch, scan, "kcore int32 sum", alive.index_select(0, a.src_pos),
                          a.head_flag, a.row_ptr[-1:], "sum", reps))
    del a, alive
    sht = wl.on_device(build_pull_shards(g_tri, 1), dev)
    at = sht.arrays
    words = (g_tri.nv + 31) // 32
    phase1 = wl.BitPatterns(bind(library.TRI_NEIGHBORS, w=words, width=words))
    bits = pull.run_pull_fixed(phase1, sht.spec, at, pull.init_state(phase1, at), 1, "scatter")
    phase2 = bind(library.TRI_COUNT)
    load, _, _ = pull.compile_pull_phases(phase2, sht.spec, "mxscan")
    src, dst = load(at, bits)[0]
    tvals = phase2.edge_value(src, at.weights[0], dst).contiguous()
    del src, dst, bits
    rows.append(scan_case(torch, scan, "triangles phase 2 f32 sum", tvals, at.head_flag[0],
                          at.row_ptr[0][-1:], "sum", reps))
    del tvals, sht, at
    torch.cuda.empty_cache()
    static, arrays = expand.plan_to_device(plan_mx, dev)
    *_, mxa = expand.split_fused_arrays(static, tuple(x[0] for x in arrays), static.weighted)
    g = dataclasses.replace(static.mx, op="sum")
    k = len(g.steps)
    idx, dst_rel, tile_block = mxa[:k], mxa[k], mxa[k + 1]
    x = torch.from_numpy(np.random.default_rng(23).integers(0, 2, static.n2)
                         .astype(np.int32)).to(dev)
    y = shuffle._relayout(x, g.view, g.perm_axes).reshape(g.kshape)
    kernel = functools.partial(shuffle.mxreduce_pass_gather, y, idx, dst_rel, tile_block, g)
    plain = functools.partial(shuffle.mxreduce_pass_gather_plain, y, idx, dst_rel, tile_block, g)
    total = sum(c for _, c, _ in static.groups)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = compare(torch, got[:total], want[:total], True, what="mx, kcore int32 sum")
    nbytes = (static.n2 * (4 + k * idx[0].element_size() + dst_rel.element_size())
              + g.num_blocks * g.v_blk * 4)
    rows.append({"kernel": "mxreduce_pass_gather", "case": "kcore int32 sum", "n2": static.n2,
                 "dtype": "int32", "exact": True, "max_abs_err": err,
                 "kernel_ms": time_ms(torch, kernel, reps),
                 "plain_ms": time_ms(torch, plain, max(2, reps // 4)), "library_ms": None,
                 "bound_ms": bound_ms(nbytes), "bytes": nbytes})
    return rows


def sum_race(torch, segment, layouts: dict, dev, reps: int) -> dict:
    """Milliseconds of one per-destination sum (ops/segment.segment_sum_csc,
    the reduce of one pull iteration) per SUM_RACE method on each layout
    of ``layouts``: {name: (values, row_ptr, head_flag, dst_local)}.  Integer
    sums must be bitwise equal across the methods (mxsum downgrades them
    to scan).  An f32 sum's largest error relative to the same sums in
    float64 is recorded: the prefix-difference method (mxsum) loses the
    global prefix's digits, so only methods within rtol 1e-5 may win.
    Returns {name: {"ms": {method: ms}, "max_rel_err": {method: err},
    "winner": method}}."""
    out = {}
    for name, (vals, row_ptr, head, dst) in layouts.items():
        fns = {m: functools.partial(segment.segment_sum_csc, vals, row_ptr, head, dst,
                                    method=m) for m in SUM_RACE}
        exact = vals.dtype != torch.float32
        if exact:
            want = fns["scan"]()
        else:
            want = torch.zeros(row_ptr.shape[0], dtype=torch.float64, device=dev)
            want.index_add_(0, dst.long(), vals.double())
            want = want[:-1]
        errs = {}
        for m, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if exact:
                compare(torch, got, want, True, what=f"race {name} {m}")
                errs[m] = 0.0
            else:
                rel = (got.double() - want).abs() / want.abs().clamp_min(1e-300)
                errs[m] = float(torch.where(want != 0, rel, (got != 0).double()).max())
        ms = {m: time_ms(torch, fn, reps) for m, fn in fns.items()}
        ok = [m for m in SUM_RACE if errs[m] <= SUM_RTOL]
        out[name] = {"ms": ms, "max_rel_err": errs, "winner": min(ok, key=ms.get)}
    return out


def spmv_2d_cases(torch, np, spmv, bc, dev, ks, reps: int, timed: bool):
    """spmv_blockcsr_2d against its plain version on one block-CSR layout,
    for each K in ``ks``, f32 and bf16 values (positive, so rtol holds);
    off the main shape also K = 20 values 4 bytes off a 16-byte boundary
    (the kernel's scalar path)."""
    gen = torch.Generator(device=dev).manual_seed(18)
    e_dst = torch.from_numpy(bc.e_dst_rel).to(dev)
    cb = torch.from_numpy(bc.chunk_block).to(dev)
    cf = torch.from_numpy(bc.chunk_first).to(dev)
    C, T = bc.e_dst_rel.shape
    n = bc.num_vblocks * bc.v_blk
    flat_dst = torch.from_numpy(np.where(
        bc.e_dst_rel < bc.v_blk,
        bc.chunk_block[:, None].astype(np.int64) * bc.v_blk + bc.e_dst_rel,
        n).reshape(-1)).to(dev)
    cases = [(k, dt, 0) for k in ks for dt in (torch.float32, torch.bfloat16)]
    if not timed:
        cases.append((20, torch.float32, 1))
    rows = []
    for k, dtype, offset in cases:
        flat = torch.rand(C * T * k + offset, device=dev, generator=gen) + 0.01
        vals = flat[offset:].view(C, T, k).to(dtype)
        del flat

        def kernel():
            return spmv.spmv_blockcsr_2d(vals, e_dst, cb, cf, v_blk=bc.v_blk,
                                         num_vblocks=bc.num_vblocks)

        def plain():
            return spmv.spmv_blockcsr_2d_plain(vals, e_dst, cb, cf, v_blk=bc.v_blk,
                                               num_vblocks=bc.num_vblocks)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        row = {"k": k, "dtype": str(dtype).replace("torch.", ""), "shape": [C, T, k],
               "offset_bytes": 4 * offset, "max_abs_err": compare(torch, got, want, False)}
        del got, want
        if timed:
            # inputs read once (values, e_dst_rel, chunk_block), output written once
            nbytes = C * T * (k * vals.element_size() + 4) + C * 4 + n * k * 4
            vflat = vals.reshape(-1, k).float()
            row.update(
                kernel_ms=time_ms(torch, kernel, reps),
                plain_ms=time_ms(torch, plain, max(2, reps // 4)),
                library_ms=time_ms(torch, lambda: torch.zeros(n + 1, k, device=dev)
                                   .index_add_(0, flat_dst, vflat), max(2, reps // 4)),
                bound_ms=bound_ms(nbytes), bytes=nbytes)
            del vflat
        rows.append(row)
        del vals
    return rows


def spec_phases(torch, np, g, sh, push_plans: dict, kernels: dict, smi: str, dev,
                spec_oracle_a, spec_oracle_b) -> dict:
    """Phases 11-12 on the main graph ``g`` (its pull layout ``sh`` and the
    phase-4 expand plans ``push_plans``): spec_main, spec_kernels and
    sum_race; the oracles are the pool's pending results.  Returns the
    launch counts of every spec run, and the single-process results phase
    dist holds its distributed workload runs to (bfs push and pull,
    kcore, and labelprop's float64 oracle)."""
    from lux_tpu_torch.apps import run as run_app
    from lux_tpu_torch.engine import methods, pull
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.shards import build_pull_shards, to_device
    from lux_tpu_torch.ops import expand, scan, segment, shuffle
    from lux_tpu_torch.program import library
    from lux_tpu_torch.program import workloads as wl
    from lux_tpu_torch.program.spec import bind

    # 11. the spec workloads through apps/run.py
    t0 = time.perf_counter()
    spec_launches = {}
    srcs = bfs_sources(np, g)
    main_argv = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0",
                 "--device", dev.type]
    bfs_argv = ["bfs"] + main_argv + ["-check", "--sources", ",".join(map(str, srcs))]
    bfs = {}
    for label, extra, replay in BFS_RUNS:
        res, spec_launches[f"bfs-{label}"] = spec_run(
            torch, run_app, "spec_main", f"bfs-{label}", bfs_argv + extra, kernels, smi, g,
            push_plans["expand-pf"] if replay else None)
        bfs[label] = res
        first = bfs["mxscan"]
        require(np.array_equal(res.state, first.state) and res.iters == first.iters
                and res.stats == first.stats,
                f"bfs {label}: (distances, iterations, traversed, dense rounds) differ "
                "from the mxscan run's")
        for name in PUSH_RUN_KERNELS.get(label, ()):
            require(spec_launches[f"bfs-{label}"][name] >= res.stats["dense_rounds"],
                    f"bfs {label}: {name} launched too few times")
    res, spec_launches["bfs-pull"] = spec_run(torch, run_app, "spec_main", "bfs-pull",
                                              bfs_argv + ["--engine", "pull"], kernels, smi, g)
    require(np.array_equal(res.state, bfs["mxscan"].state), "bfs pull: distances differ")
    require(spec_launches["bfs-pull"]["mxscan_segmented"] >= res.iters,
            "bfs pull: the scan kernel launched too few times")
    spec_ref = {"sources": srcs,
                "bfs": {"state": bfs["mxscan"].state, "iters": bfs["mxscan"].iters,
                        "stats": bfs["mxscan"].stats},
                "bfs-pull": {"state": res.state, "iters": res.iters}}
    o_dist, o_probs, o_secs = spec_oracle_a.result(timeout=900)
    require(np.array_equal(bfs["mxscan"].state, o_dist), "bfs distances differ from scipy's")
    emit({"phase": "spec_main", "program": "bfs", "sources": srcs,
          "oracle": "scipy.sparse.csgraph shortest_path, min over the sources",
          "oracle_seconds": o_secs["bfs"], "reached": int((o_dist < g.nv).sum()),
          "oracle_equal": True})

    # k-core on the symmetrized main graph, its int32 sums through the
    # scan kernel (the other methods run at KCORE_ROUTED_SCALE below)
    kc = {}
    kc["mxscan"], spec_launches["kcore-mxscan"] = spec_run(
        torch, run_app, "spec_main", "kcore-mxscan",
        ["kcore"] + main_argv + ["-check", "--method", "mxscan"], kernels, smi, g)
    require(spec_launches["kcore-mxscan"]["mxscan_segmented"] >= kc["mxscan"].iters,
            "kcore mxscan: the scan kernel launched fewer times than the rounds")
    o_core, o_inc, o2_secs = spec_oracle_b.result(timeout=900)
    require(np.array_equal(kc["mxscan"].state, o_core), "coreness differs from the host peel")
    spec_ref["kcore"] = {"state": kc["mxscan"].state, "iters": kc["mxscan"].iters,
                         "stats": kc["mxscan"].stats}
    spec_ref["labelprop64"] = o_probs
    gs = kc["mxscan"].graph
    emit({"phase": "spec_main", "program": "kcore", "ne_symmetrized": gs.ne,
          "max_degree": int(gs.in_degrees().max()), "k_max": kc["mxscan"].stats["k_max"],
          "rounds": kc["mxscan"].iters, "oracle": "host peel by removed out-edges",
          "oracle_seconds": o2_secs["kcore"], "oracle_equal": True})

    # routed k-core at KCORE_ROUTED_SCALE: the plans built once, handed to the app
    g16 = generate.rmat(KCORE_ROUTED_SCALE, EF, seed=0)
    sh16 = build_pull_shards(wl.symmetrize(g16), 1)
    t1 = time.perf_counter()
    plans16 = {"fused-mx": expand.plan_fused_shards(sh16, "sum", pf=True, mx=True)}
    t2 = time.perf_counter()
    plans16["expand-pf"] = expand.plan_expand_shards(sh16, pf=True)
    emit({"phase": "spec_main", "program": "kcore", "plan_scale": KCORE_ROUTED_SCALE,
          "plan_seconds": {"fused-mx": t2 - t1, "expand-pf": time.perf_counter() - t2}})
    argv16 = ["kcore", "--rmat-scale", str(KCORE_ROUTED_SCALE), "--rmat-ef", str(EF),
              "--seed", "0", "--device", dev.type, "-check", "--method", "mxscan"]
    k16, spec_launches["kcore16-mxscan"] = spec_run(torch, run_app, "spec_main",
                                                    "kcore16-mxscan", argv16, kernels, smi, g16)
    res, spec_launches["kcore16-scatter"] = spec_run(
        torch, run_app, "spec_main", "kcore16-scatter", argv16[:-1] + ["scatter"], kernels,
        smi, g16)
    require(np.array_equal(res.state, k16.state)
            and (res.iters, res.stats) == (k16.iters, k16.stats),
            "kcore scatter: (coreness, rounds, k_max) differ from the mxscan run's")
    for mode in KCORE_ROUTED:
        res, spec_launches[f"kcore16-{mode}"] = spec_run(
            torch, run_app, "spec_main", f"kcore16-{mode}", argv16 + ["--route-gather", mode],
            kernels, smi, g16, plans16[mode])
        require(np.array_equal(res.state, k16.state)
                and (res.iters, res.stats) == (k16.iters, k16.stats),
                f"kcore {mode}: (coreness, rounds, k_max) differ from the direct run's")
        name = RUN_KERNEL[mode]
        require(spec_launches[f"kcore16-{mode}"][name] >= res.iters,
                f"kcore {mode}: {name} launched fewer times than the rounds")

    # label propagation: wide (V, 8) state
    lp = {}
    for label, extra in (("auto", []), ("scatter", ["--method", "scatter"])):
        res, spec_launches[f"labelprop-{label}"] = spec_run(
            torch, run_app, "spec_main", f"labelprop-{label}",
            ["labelprop"] + main_argv + ["-check", "-ni", str(ITERS), "--labels",
                                         str(LP_LABELS), "--seed-stride", str(LP_STRIDE)]
            + extra, kernels, smi, g)
        lp[label] = res
        err = float(np.max(np.abs(res.state - o_probs)))
        require(res.state.shape == (g.nv, LP_LABELS) and bool(np.isfinite(res.state).all()),
                f"labelprop {label}: probabilities not finite or misshaped")
        require(np.allclose(res.state, o_probs, rtol=LP_RTOL, atol=LP_ATOL),
                f"labelprop {label}: off the float64 oracle by {err}")
        emit({"phase": "spec_main", "program": "labelprop", "run": label,
              "max_abs_err_vs_f64": err, "rtol": LP_RTOL, "atol": LP_ATOL,
              "oracle": "float64 recurrence as scipy CSR products",
              "oracle_seconds": o_secs["labelprop"]})

    # triangles on the symmetrized weighted TRI_SCALE graph
    g15 = generate.rmat(TRI_SCALE, EF, seed=0, weighted=True)
    tri = {}
    for label, extra in (("mxscan", ["--method", "mxscan", "-check"]),
                         ("scatter", ["--method", "scatter"])):
        res, spec_launches[f"triangles-{label}"] = spec_run(
            torch, run_app, "spec_main", f"triangles-{label}",
            ["triangles", "--rmat-scale", str(TRI_SCALE), "--rmat-ef", str(EF), "--seed", "0",
             "--device", dev.type] + extra, kernels, smi, g15)
        tri[label] = res
        ref = o_inc.astype(np.float64)
        bad = int(np.sum(~np.isfinite(res.state)
                         | (np.abs(res.state - ref) > 1e-5 * np.maximum(np.abs(ref), 1.0))))
        require(res.state.shape == (g15.nv,) and bad == 0,
                f"triangles {label}: {bad} vertices off the bitset oracle")
        emit({"phase": "spec_main", "program": "triangles", "run": label, "bad_vertices": bad,
              "total_weighted_incidence": res.stats["total_weighted_incidence"],
              "bitset_words": res.stats["bitset_words"], "ne_symmetrized": res.graph.ne,
              "oracle": "numpy bitsets, per-edge set bits of the intersection",
              "oracle_seconds": o2_secs["triangles"]})
    require(spec_launches["triangles-mxscan"]["mxscan_segmented"] >= 1,
            "triangles mxscan: phase 2 launched no scan kernel")
    emit({"phase": "spec_main", "seconds": time.perf_counter() - t0, "device": smi})

    # the slice's new kernel callers against their plain versions
    t0 = time.perf_counter()
    spec_rows = spec_kernel_cases(torch, np, scan, shuffle, expand, pull, wl, library, bind,
                                  kc["mxscan"], tri["mxscan"].graph, plans16["fused-mx"],
                                  dev, REPS)
    emit({"phase": "spec_kernels", "cases": spec_rows, "seconds": time.perf_counter() - t0,
          "device": smi})
    del plans16, sh16, g16, g15, bfs, lp, tri
    torch.cuda.empty_cache()

    # 12. the sum race: one reduce of one iteration, per method
    t0 = time.perf_counter()
    shk = build_pull_shards(gs, 1)
    core = torch.from_numpy(kc["mxscan"].state).to(dev)
    layouts = {}
    for name, shx, full in (
            ("pagerank_f32", sh, torch.from_numpy(
                np.random.default_rng(21).random(sh.spec.gathered_size, dtype=np.float32)
                + 0.01).to(dev)),
            ("kcore_int32", shk, torch.cat([(core >= 2).to(torch.int32), torch.zeros(
                shk.spec.gathered_size - gs.nv, dtype=torch.int32, device=dev)]))):
        a = to_device(shx.arrays, dev).part(0)
        layouts[name] = (full.index_select(0, a.src_pos), a.row_ptr, a.head_flag, a.dst_local)
    race_sum = sum_race(torch, segment, layouts, dev, REPS)
    emit({"phase": "sum_race", "race": race_sum,
          "winners_row": methods.WINNERS.get(("cuda", "sum")),
          "graph": {"pagerank_f32": [g.nv, g.ne], "kcore_int32": [gs.nv, gs.ne]},
          "seconds": time.perf_counter() - t0, "device": smi})
    return spec_launches, spec_ref


def save_graph(np, tmp: str, name: str, g) -> None:
    """A HostGraph's arrays as .npy files under ``tmp`` (the pool's
    hand-off of a generated graph to the card's process)."""
    for f in ("row_ptr", "col_idx", "weights"):
        if getattr(g, f) is not None:
            np.save(os.path.join(tmp, f"{name}_{f}.npy"), getattr(g, f))


def load_saved_graph(np, csc, tmp: str, name: str):
    arrs = {f: np.load(os.path.join(tmp, f"{name}_{f}.npy"))
            for f in ("row_ptr", "col_idx", "weights")
            if os.path.exists(os.path.join(tmp, f"{name}_{f}.npy"))}
    return csc.HostGraph(nv=arrs["row_ptr"].shape[0] - 1, ne=arrs["col_idx"].shape[0],
                         row_ptr=arrs["row_ptr"], col_idx=arrs["col_idx"],
                         weights=arrs.get("weights"))


def long_weighted_graph(tmp: str, scale: int):
    """The weighted main graph (RMAT ``scale`` / EF / seed 0, integer
    weights 1..100: the unweighted graph's edges, so its hub is the same
    vertex), saved under ``tmp``, and scipy's Dijkstra distances from that
    hub (the lightest of parallel edges; INF == 1 << 30).  Returns (hub,
    distances, seconds).  Runs in a spawned process while the card works."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from lux_tpu_torch.graph import generate

    t0 = time.perf_counter()
    g = generate.rmat(scale, EF, seed=0, weighted=True)
    save_graph(np, tmp, "weighted", g)
    hub = int(np.argmax(g.out_degrees()))
    dst = g.dst_of_edges()
    order = np.lexsort((g.weights, g.col_idx, dst))
    s, d, w = g.col_idx[order], dst[order], g.weights[order]
    first = np.ones(g.ne, bool)
    first[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
    adj = csr_matrix((w[first].astype(np.float64), (s[first], d[first])), shape=(g.nv, g.nv))
    dist = dijkstra(adj, directed=True, indices=hub)
    return hub, np.where(np.isfinite(dist), dist, 1 << 30).astype(np.int32), \
        time.perf_counter() - t0


def long_stream_graph(tmp: str, scale: int):
    """The streamed runs' graph (RMAT ``scale`` / EF / seed 0) saved under
    ``tmp``, and its float64 PageRank oracle of ITERS iterations.
    Returns (oracle, seconds).  Runs in a spawned process."""
    import numpy as np

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models.pagerank import pagerank_reference

    t0 = time.perf_counter()
    g = generate.rmat(scale, EF, seed=0)
    save_graph(np, tmp, "stream", g)
    return pagerank_reference(g, ITERS), time.perf_counter() - t0


def scan_case(torch, scan, case: str, vals, head, valid_end, op: str, reps: int):
    """The scan kernel's segmented ``op`` of ``vals`` on one caller's
    shape against its plain version on the valid slots: int32 and min/max
    bitwise, an f32 sum within rtol 1e-5 of the same sum in float64; two
    calls bitwise; timed beside its bound."""
    n = vals.shape[0]
    kernel = functools.partial(scan.mxscan_segmented, vals, head, op=op, valid_end=valid_end)
    plain = functools.partial(scan.mxscan_segmented_plain, vals, head, op=op,
                              valid_end=valid_end)
    exact = not (op == "sum" and vals.dtype == torch.float32)
    got = kernel()
    want = plain() if exact else scan.segmented_scan(vals.double(), head, torch.add)
    torch.cuda.synchronize()
    mask = torch.arange(n, device=vals.device) < valid_end
    what = f"scan, {case}"
    err = compare(torch, got, want, exact, mask, what=what)
    require(torch.equal(got, kernel()), f"{what}: two calls differ")
    nbytes = n * (2 * vals.element_size() + 1)
    return {"kernel": "mxscan_segmented", "case": case, "op": op, "n": n,
            "dtype": str(vals.dtype).replace("torch.", ""), "exact": exact,
            "valid": int(valid_end.item()), "max_abs_err": err,
            "kernel_ms": time_ms(torch, kernel, reps),
            "plain_ms": time_ms(torch, plain, max(2, reps // 4)), "library_ms": None,
            "bound_ms": bound_ms(nbytes), "bytes": nbytes}


def counted(kernels: dict, fn, *args, **kw):
    """``fn(*args, **kw)`` with every launch counter set to 0 just before
    and read just after: (result, {kernel: launches}, wall seconds)."""
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = fn(*args, **kw)
    return res, {name: k.launches for name, k in kernels.items()}, time.perf_counter() - t0


def delta_main(torch, np, kernels, smi, dev, tmp, long_w, plan_pf, hub, reps):
    """Phase 13: weighted SSSP from the hub through apps.sssp: chaotic,
    --delta at DELTA_WIDTHS, and --delta DELTA_ROUTED with --route-gather
    expand-pf (phase 4's plan: the weighted graph has the main graph's
    edges); all equal to each other and to scipy's Dijkstra.  Then the
    scan kernel's int32 min at one dense round of the weighted layout.
    Returns (the weighted graph, {run: result}, {run: launches}, the
    kernel row)."""
    from lux_tpu_torch.apps import sssp as sssp_app
    from lux_tpu_torch.graph import csc
    from lux_tpu_torch.graph.shards import build_pull_shards, to_device
    from lux_tpu_torch.models import sssp as sssp_model
    from lux_tpu_torch.ops import scan

    t0 = time.perf_counter()
    w_hub, w_dist, w_secs = long_w.result(timeout=900)
    require(w_hub == hub, f"the weighted graph's hub {w_hub} is not the main graph's {hub}")
    gw = load_saved_graph(np, csc, tmp, "weighted")
    base = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0", "--weighted",
            "-start", str(hub), "-check", "--device", "cuda", "--method", "mxscan"]
    routed = f"delta-{DELTA_ROUTED}-expand-pf"
    cases = ([("chaotic", [], None)]
             + [(f"delta-{d}", ["--delta", str(d)], None) for d in DELTA_WIDTHS]
             + [(routed, ["--delta", str(DELTA_ROUTED), "--route-gather", "expand-pf"],
                 plan_pf)])
    runs, launches = {}, {}
    for label, extra, plan in cases:
        res, counts, wall = counted(kernels, sssp_app.run, base + extra, route=plan, graph=gw)
        runs[label], launches[label] = res, counts
        emit({"phase": "delta_main", "run": label, "argv": extra, "rc": res.rc,
              "rounds": res.iters, "dense_rounds": res.dense_rounds,
              "traversed_edges": res.traversed, "ms": res.seconds * 1e3, "gteps": res.gteps,
              "launches": counts, "wall_seconds": wall, "device": smi})
        require(res.rc == 0, f"delta_main {label}: -check failed")
        require(np.array_equal(res.state, w_dist),
                f"delta_main {label}: distances differ from scipy's Dijkstra")
        require(counts["mxscan_segmented"] >= res.dense_rounds,
                f"delta_main {label}: mxscan launched {counts['mxscan_segmented']} times in "
                f"{res.dense_rounds} dense rounds")
    plain = runs[f"delta-{DELTA_ROUTED}"]
    require((runs[routed].iters, runs[routed].traversed) == (plain.iters, plain.traversed),
            "delta_main: the routed run's rounds or edges differ from the direct one's")
    require(runs[routed].dense_rounds > 0, "delta_main: the routed run had no dense round")
    for name in ("fused_pass_gather", "lane_gather"):
        require(launches[routed][name] > 0, f"delta_main: the routed run launched no {name}")
    sh = build_pull_shards(gw, 1)
    a = to_device(sh.arrays, dev).part(0)
    prog = sssp_model.WeightedSSSPProgram(nv=gw.nv, start=hub)
    full = prog.init_state(a.global_vid, a.degree, a.vtx_mask)
    full[: gw.nv] = torch.from_numpy(runs["delta-%d" % DELTA_WIDTHS[0]].state).to(dev)
    vals = prog.relax(full.index_select(0, a.src_pos), a.weights).contiguous()
    row = scan_case(torch, scan, "delta dense round int32 min", vals, a.head_flag,
                         a.row_ptr[-1:], "min", reps)
    emit({"phase": "delta_main", "oracle": "scipy.sparse.csgraph.dijkstra",
          "oracle_seconds": w_secs, "hub": hub, "reached": int((w_dist < (1 << 30)).sum()),
          "kernel": row, "seconds": time.perf_counter() - t0, "device": smi})
    del a, full, vals, sh
    return gw, runs, launches, row


def variants_plan(plan_dir: str):
    """Phase 4's sixth process: the "min" fused-mx plan of the weighted main
    graph (RMAT SCALE / EF / seed 0, integer weights 1..100, drawn here from
    the seed as the pool's long_weighted_graph draws it), built into the
    plan cache that phase 13b loads.  Returns its seconds."""
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.ops import expand

    t0 = time.perf_counter()
    g = generate.rmat(SCALE, EF, seed=0, weighted=True)
    expand.plan_fused_shards_cached(build_pull_shards(g, 1), "min", cache_dir=plan_dir,
                                    mx=True)
    return {"scale": SCALE, "reduce": "min", "weighted": True,
            "seconds": time.perf_counter() - t0, "process_cpu_seconds": time.process_time()}


def bf16_sum_err(torch, got, want64, what: str) -> float:
    """A bf16 sum against the same sum in float64, at BF16_RTOL / BF16_ATOL
    (one rounding to bf16's 8 bits); the max abs difference."""
    g64 = got.double()
    diff = (g64 - want64).abs()
    bad = diff > BF16_ATOL + BF16_RTOL * want64.abs()
    require(not bool(bad.any()), f"{what}: {int(bad.sum())} places outside rtol "
            f"{BF16_RTOL} / atol {BF16_ATOL} of float64")
    return float(diff.max()) if diff.numel() else 0.0


def variant_row(torch, form: str, entry: str, launches: int, err: float, kernel, plain,
                nbytes: int, library, reps: int) -> dict:
    """One new form's record: its launches through ``entry`` on the path's
    run, its error, and the kernel, plain and library times (means between
    CUDA events) beside the bound of ``nbytes``."""
    return {"form": form, "entry": entry, "launches": launches, "max_abs_err": err,
            "ms": time_ms(torch, kernel, reps), "plain_ms": time_ms(torch, plain, max(2, reps // 4)),
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "bytes": nbytes,
            "library_ms": None if library is None else time_ms(torch, library, reps)}


def variants_main(torch, np, kernels, smi, dev, g, sh, gw, w_dist, hub, plan_dir, plan_sum,
                  reps):
    """Phase 13b: the bf16 and weighted-edge forms of the scan, mx and spmv
    kernels at the main path's shapes, each driven once through its entry
    point (counters 0 just before, read just after), held against its plain
    twin (min/max bitwise) or float64 sums, and timed; then weighted SSSP
    through run_pull_until on the "min" fused-mx plan of phase 4 from the
    hub, bitwise phase 13's apps.sssp --weighted distances.  Returns
    ({kernel: [variant rows]}, {kernel: launches on the phase's driven
    calls})."""
    from lux_tpu_torch.engine import pull
    from lux_tpu_torch.graph.shards import build_pull_shards, to_device
    from lux_tpu_torch.models import sssp as sssp_model
    from lux_tpu_torch.ops import expand, scan, segment, shuffle, spmv
    from lux_tpu_torch.program import library, spec

    t0 = time.perf_counter()
    rows = {"mxscan_segmented": [], "mxreduce_pass_gather": [], "spmv_blockcsr": []}
    total = {k: 0 for k in kernels}

    def drive(fn, *a, **kw):
        res, counts, _ = counted(kernels, fn, *a, **kw)
        for k, n in counts.items():
            total[k] += n
        return res, counts

    rng = np.random.default_rng(23)
    state = torch.from_numpy(rng.random(sh.spec.gathered_size, dtype=np.float32)
                             + 0.01).to(dev).to(torch.bfloat16)

    # the scan: segment_*_csc(method="mxscan") on the main pull layout's slots
    a = to_device(sh.arrays, dev).part(0)
    vals = state.index_select(0, a.src_pos).contiguous()
    n = vals.numel()
    end = a.row_ptr[-1:]
    valid = torch.arange(n, device=dev) < end
    for op in ("sum", "min", "max"):
        fn = {"sum": segment.segment_sum_csc, "min": segment.segment_min_csc,
              "max": segment.segment_max_csc}[op]
        out, counts = drive(fn, vals, a.row_ptr, a.head_flag, a.dst_local, method="mxscan")
        what = f"variants: scan bf16 {op}"
        require(out.dtype == torch.bfloat16 and counts["mxscan_segmented"] == 1,
                f"{what}: {out.dtype}, {counts['mxscan_segmented']} launches")
        kernel = functools.partial(scan.mxscan_segmented, vals, a.head_flag, op=op,
                                   valid_end=end)
        plain = functools.partial(scan.mxscan_segmented_plain, vals, a.head_flag, op=op,
                                  valid_end=end)
        got = kernel()
        if op == "sum":
            # float64 sums by the plain version (index_add_; the kernel sums f32)
            ends = segment.segment_sum_sorted_plain(vals.double(), a.dst_local,
                                                    a.row_ptr.shape[0] - 1)
            err = max(bf16_sum_err(torch, got[valid], scan.segmented_scan(
                vals.double(), a.head_flag, torch.add)[valid], what),
                bf16_sum_err(torch, out, ends, f"{what} (segment ends)"))
        else:
            err = compare(torch, got, plain(), True, valid, what=what)
            require(torch.equal(out, fn(vals, a.row_ptr, a.head_flag, a.dst_local,
                                        method="scatter")), f"{what}: ends differ from scatter")
        require(torch.equal(got, kernel()), f"{what}: two calls differ")
        rows["mxscan_segmented"].append(variant_row(
            torch, f"bf16 {op}", f"ops/segment.segment_{op}_csc(method='mxscan')",
            counts["mxscan_segmented"], err, kernel, plain, n * 5, None, reps))
    del vals, valid

    # the spmv: bf16 min and max on the main block-CSR layout
    bc = spmv.build_blockcsr(g)
    C, T = bc.e_dst_rel.shape
    nv_pad = bc.num_vblocks * bc.v_blk
    e_dst = torch.from_numpy(bc.e_dst_rel).to(dev)
    cb = torch.from_numpy(bc.chunk_block).to(dev)
    cf = torch.from_numpy(bc.chunk_first).to(dev)
    sv = state[: g.nv]
    svals = torch.cat([sv, sv.new_zeros(nv_pad - g.nv)])[
        torch.from_numpy(bc.e_src_pos).to(dev).long()].contiguous()
    flat = torch.from_numpy(np.where(
        bc.e_dst_rel < bc.v_blk, bc.chunk_block[:, None].astype(np.int64) * bc.v_blk
        + bc.e_dst_rel, nv_pad).reshape(-1)).to(dev)
    for op in ("min", "max"):
        kw = dict(op=op, v_blk=bc.v_blk, num_vblocks=bc.num_vblocks)
        got, counts = drive(spmv.spmv_blockcsr, svals, e_dst, cb, cf, **kw)
        what = f"variants: spmv bf16 {op}"
        require(got.dtype == torch.bfloat16, f"{what}: {got.dtype}")
        err = compare(torch, got, spmv.spmv_blockcsr_plain(svals, e_dst, cb, cf, **kw), True,
                      what=what)
        red = "amin" if op == "min" else "amax"
        vflat = svals.reshape(-1)
        rows["spmv_blockcsr"].append(variant_row(
            torch, f"bf16 {op}", "ops/spmv.spmv_blockcsr", counts["spmv_blockcsr"], err,
            functools.partial(spmv.spmv_blockcsr, svals, e_dst, cb, cf, **kw),
            functools.partial(spmv.spmv_blockcsr_plain, svals, e_dst, cb, cf, **kw),
            C * T * 6 + nv_pad * 2,
            lambda: torch.full((nv_pad + 1,), float("inf") if op == "min" else float("-inf"),
                               dtype=torch.bfloat16, device=dev).scatter_reduce_(
                                   0, flat, vflat, red), reps))
    del bc, e_dst, cb, cf, svals, flat

    # the mx kernel: bf16 sum on phase 4's main fused-mx plan, bf16 min on the
    # weighted graph's "min" plan (loaded from phase 4's cache)
    shw = build_pull_shards(gw, 1)
    built0 = expand.plan_stats_snapshot()["built"]
    plan_min = expand.plan_fused_shards_cached(shw, "min", cache_dir=plan_dir, mx=True)
    require(expand.plan_stats_snapshot()["built"] == built0,
            "variants: the min fused-mx plan was built here, not loaded from phase 4's cache")
    on_dev = {"sum": expand.plan_to_device(plan_sum, dev),
              "min": expand.plan_to_device(plan_min, dev)}
    for op, layout in (("sum", sh), ("min", shw)):
        static, arrays = on_dev[op]
        part = tuple(x[0] for x in arrays)
        acc, counts = drive(expand.apply_fused, state, static, part)
        what = f"variants: mx bf16 {op}"
        require(counts["mxreduce_pass_gather"] == 1,
                f"{what}: {counts['mxreduce_pass_gather']} mx launches")
        la = to_device(layout.arrays, dev).part(0)
        src = state.index_select(0, la.src_pos)
        if op == "sum":
            want = segment.segment_sum_sorted_plain(src.double(), la.dst_local,
                                                    la.row_ptr.shape[0] - 1)
            require(acc.dtype == torch.float32, f"{what}: totals {acc.dtype}")
            compare(torch, acc, want, False, what=f"{what} (apply_fused)")
        else:
            want = segment.segment_min_csc(src, la.row_ptr, la.head_flag, la.dst_local,
                                           method="scatter")
            require(acc.dtype == torch.bfloat16 and torch.equal(acc, want),
                    f"{what}: apply_fused differs from the scatter min")
        *_, mxa = expand.split_fused_arrays(static, part, static.weighted)
        g_mx = static.mx
        k = len(g_mx.steps)
        idx, dst_rel, tile_block = mxa[:k], mxa[k], mxa[k + 1]
        total_slots = sum(c for _, c, _ in static.groups)
        x = torch.from_numpy(rng.random(static.n2, dtype=np.float32) + 0.01).to(dev)
        y = shuffle._relayout(x.to(torch.bfloat16), g_mx.view, g_mx.perm_axes).reshape(
            g_mx.kshape)
        kernel = functools.partial(shuffle.mxreduce_pass_gather, y, idx, dst_rel, tile_block,
                                   g_mx)
        plain = functools.partial(shuffle.mxreduce_pass_gather_plain, y, idx, dst_rel,
                                  tile_block, g_mx)
        got = kernel()
        want = (mx_sum_f64(torch, shuffle, y, idx, dst_rel, tile_block, g_mx) if op == "sum"
                else plain())
        err = compare(torch, got[:total_slots], want[:total_slots], op != "sum", what=what)
        require(torch.equal(got, kernel()), f"{what}: two calls differ")
        nbytes = (static.n2 * (2 + k * idx[0].element_size() + dst_rel.element_size())
                  + g_mx.num_blocks * g_mx.v_blk * got.element_size())
        rows["mxreduce_pass_gather"].append(variant_row(
            torch, f"bf16 {op}", "ops/expand.apply_fused", counts["mxreduce_pass_gather"], err,
            kernel, plain, nbytes, None, reps))
        del la, src, want, x, y, got
    del on_dev["sum"]
    emit({"phase": "variants", "kernels": rows, "seconds": time.perf_counter() - t0,
          "device": smi})

    # the weighted path: run_pull_until on the "min" fused-mx plan, from the hub
    t1 = time.perf_counter()
    arrays = to_device(shw.arrays, dev)
    prog = spec.bind(library.SSSP_WEIGHTED, inf=1 << 30, start=hub)
    s0 = pull.init_state(prog, arrays)

    def run():
        out = pull.run_pull_until(prog, shw.spec, arrays, s0, 10_000, spec.active_changed,
                                  route=on_dev["min"])
        torch.cuda.synchronize()
        return out

    run()  # untimed: lazy loading, clocks
    t2 = time.perf_counter()
    (state_w, iters), counts = drive(run)
    seconds = time.perf_counter() - t2
    dist = shw.scatter_to_global(state_w.cpu().numpy())
    bad = sssp_model.check_distances(gw, dist, weighted=True)
    row = {"phase": "variants", "run": "weighted sssp pull-until fused-mx", "hub": hub,
           "iters": iters, "ms_per_iter": seconds * 1e3 / iters, "ms": seconds * 1e3,
           "gteps": iters * gw.ne / seconds / 1e9, "idle_share": "not measured",
           "launches": counts, "violations": int(bad), "ne": gw.ne,
           "wall_seconds": time.perf_counter() - t1, "device": smi}
    emit(row)
    require(np.array_equal(dist, w_dist),
            "variants: weighted SSSP pull-until differs from phase 13's apps.sssp --weighted")
    require(bad == 0, f"variants: {bad} violations of the weighted distances")
    require(counts["mxreduce_pass_gather"] >= iters,
            f"variants: mxreduce launched {counts['mxreduce_pass_gather']} times in {iters}")
    emit({"phase": "variants", "seconds": time.perf_counter() - t0, "device": smi})
    return rows, total, row


def repart_main(np, kernels, smi, g, o_tail, o_labels):
    """Phase 14: -ng REPART_PARTS on the card through apps.sssp (from
    ``tail_start``, whose BFS distances ``o_tail`` the pool computed) and
    apps.components, static and with --repartition-every REPART_EVERY
    (threshold REPART_THRESHOLD), and SSSP again with windows of one
    iteration, whose first window (one vertex's out-edges) must recut;
    equal to each other and to the oracles.  Each recut's window
    imbalance, and the same window's work under the new cuts.  Returns
    {app: launches of the REPART_EVERY run}."""
    from lux_tpu_torch.apps import components as cc_app
    from lux_tpu_torch.apps import sssp as sssp_app
    from lux_tpu_torch.engine import repartition

    t0 = time.perf_counter()
    launches, tail = {}, None
    for name, mod, extra, oracle, every in (
            ("sssp", sssp_app, ["-start", str(tail_start(np, g))], o_tail, REPART_EVERY),
            ("sssp", sssp_app, ["-start", str(tail_start(np, g))], o_tail, 1),
            ("components", cc_app, [], o_labels, REPART_EVERY)):
        base = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0",
                "-ng", str(REPART_PARTS), "--method", "mxscan", "-check",
                "--device", "cuda"] + extra
        if every == REPART_EVERY:
            static, _, _ = counted(kernels, mod.run, base, graph=g)
            if name == "sssp":  # phase dist's adaptive run must equal it
                tail = {"start": tail_start(np, g), "iters": static.iters,
                        "traversed": static.traversed}
        res, counts, wall = counted(kernels, mod.run,
                                    base + ["--repartition-every", str(every),
                                            "--repartition-threshold", str(REPART_THRESHOLD)],
                                    graph=g)
        launches.setdefault(name, counts)
        recuts = []
        for it, old, new, work in res.recuts:
            old, new, work = np.asarray(old), np.asarray(new), np.asarray(work)
            cum = np.concatenate([[0.0], np.cumsum(
                repartition.vertex_weights(work, old, g.row_ptr))])
            recuts.append({"it": it, "old_cuts": old.tolist(), "new_cuts": new.tolist(),
                           "imbalance_before": repartition.imbalance(work),
                           "imbalance_after_estimate": repartition.imbalance(
                               cum[new[1:]] - cum[new[:-1]]),
                           "max_boundary_move": int(np.abs(new - old).max())})
        emit({"phase": "repart_main", "app": name, "argv": extra, "parts": REPART_PARTS,
              "every": every, "threshold": REPART_THRESHOLD, "rc": res.rc, "recuts": recuts,
              "iters": res.iters, "dense_rounds": res.dense_rounds,
              "traversed_edges": res.traversed, "ms": res.seconds * 1e3, "gteps": res.gteps,
              "static_ms": static.seconds * 1e3, "static_gteps": static.gteps,
              "launches": counts, "wall_seconds": wall, "device": smi})
        require(res.rc == 0 and static.rc == 0, f"repart_main {name}: -check failed")
        require(np.array_equal(res.state, static.state),
                f"repart_main {name}: the adaptive state differs from the static one")
        require(np.array_equal(res.state, oracle), f"repart_main {name}: state off the oracle")
        require((res.iters, res.traversed) == (static.iters, static.traversed),
                f"repart_main {name}: iterations or edges differ from the static run")
        require(counts["mxscan_segmented"] >= res.dense_rounds,
                f"repart_main {name}: mxscan launched {counts['mxscan_segmented']} times")
        if every == 1:  # a one-vertex first window: its uneven work must recut
            require(recuts, "repart_main sssp: --repartition-every 1 made no recut")
    emit({"phase": "repart_main", "seconds": time.perf_counter() - t0})
    return launches, tail


def stream_main(torch, np, kernels, smi, dev, tmp, long_s, reps):
    """Phase 15: PageRank (ITERS iterations) and components on RMAT
    STREAM_SCALE through the apps with --stream-hbm-gib STREAM_GIB:
    PageRank within rtol 1e-4 of its float64 oracle, components bitwise
    the resident pull run, prefetch on and off bitwise; the geometry, the
    bytes an iteration moves, ms an iteration with prefetch on and off,
    the rate of a plain pinned copy of the same bytes, the link bound,
    and the peak memory beside the budget and the estimate.  Then the
    scan kernel on one chunk whose first segment began in an earlier
    chunk.  Returns (launches {app: counts}, kernel rows)."""
    from lux_tpu_torch.apps import components as cc_app
    from lux_tpu_torch.apps import pagerank as pr_app
    from lux_tpu_torch.engine import pull, stream
    from lux_tpu_torch.graph import csc
    from lux_tpu_torch.graph.shards import to_device
    from lux_tpu_torch.models import components as cc_model
    from lux_tpu_torch.models.pagerank import PageRankProgram
    from lux_tpu_torch.ops import scan
    from lux_tpu_torch.utils.timing import Timer

    t0 = time.perf_counter()
    pr64, oracle_s = long_s.result(timeout=1100)
    gs = load_saved_graph(np, csc, tmp, "stream")
    argv = ["--rmat-scale", str(STREAM_SCALE), "--rmat-ef", str(EF), "--seed", "0",
            "--device", "cuda", "--method", "mxscan", "--stream-hbm-gib", str(STREAM_GIB)]
    launches, rows = {}, []
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = counted(kernels, pr_app.run, argv + ["-ni", str(ITERS)], graph=gs)
    peak = torch.cuda.max_memory_allocated() - base_mem
    launches["pagerank"] = counts
    st = res.streamed
    ssh = st.layout
    rel = float(np.max(np.abs(res.ranks.astype(np.float64) - pr64)
                       / np.abs(pr64.astype(np.float64))))
    moved = ssh.packed.numel()  # every chunk row crosses the link once an iteration
    prog = PageRankProgram(nv=gs.nv)
    s0 = pull.init_state(prog, to_device(ssh.varrays, dev))
    on_off = {}
    for prefetch in (True, False):
        timer = Timer(dev)
        out = stream.run_pull_fixed_streamed(prog, ssh, s0, ITERS, "mxscan", prefetch)
        on_off[prefetch] = (timer.stop() * 1e3 / ITERS, out)
    require(torch.equal(on_off[True][1], on_off[False][1]),
            "stream_main: prefetch on and off differ")
    # the plain pinned copy of the same bytes, chunk by chunk into one buffer
    buf = torch.empty(ssh.packed.shape[2], dtype=torch.uint8, device=dev)
    rows_host = ssh.packed.reshape(-1, ssh.packed.shape[2])

    def copy_all():
        for r in range(rows_host.shape[0]):
            buf.copy_(rows_host[r], non_blocking=True)

    copy_ms = time_ms(torch, copy_all, 3, warmup=1)
    rate = moved / (copy_ms * 1e-3)
    # the scan kernel on one chunk whose first segment began in an earlier chunk
    rp = ssh.row_ptrs[0]
    c = next(c for c, ch in enumerate(ssh.chunks[0])
             if c and int(ch.dst_local[0]) < ssh.spec.nv_pad
             and rp[int(ch.dst_local[0])] < ch.lo)
    ch = ssh.chunks[0][c]
    xfer = stream._Transfer(ssh, dev)
    xfer.put(0, 0, c, after=0)
    chunk = xfer.take(0, 0, c)
    full = on_off[True][1].reshape(-1)
    vals = full.index_select(0, chunk.src_pos).contiguous()
    rows.append(scan_case(torch, scan, "streamed chunk f32 sum", vals, chunk.head_flag,
                               chunk.row_ptr[-1:], "sum", reps))
    labels = chunk.src_pos.clone()  # max-label values: the sources' positions
    rows.append(scan_case(torch, scan, "streamed chunk int32 max", labels,
                               chunk.head_flag, chunk.row_ptr[-1:], "max", reps))
    emit({"phase": "stream_main", "app": "pagerank", "scale": STREAM_SCALE,
          "nv": gs.nv, "ne": gs.ne, "rc": res.rc, "max_rel_err_vs_f64": rel,
          "chunks_per_part": st.n_chunks, "chunk_edges": st.chunk_e, "parts": 1,
          "bytes_per_iter": moved, "ms_per_iter": res.seconds * 1e3 / ITERS,
          "gteps": res.gteps, "ms_per_iter_prefetch_on": on_off[True][0],
          "ms_per_iter_prefetch_off": on_off[False][0],
          "pinned_copy_gb_per_s": rate / 1e9, "link_bound_ms_per_iter": copy_ms,
          "peak_bytes": peak, "budget_bytes": st.budget_bytes,
          "estimate_bytes": st.resident_bytes, "edge_bytes_resident_engine": st.edge_bytes,
          "kernel_chunk": c, "kernel": rows, "launches": counts, "wall_seconds": wall,
          "oracle_seconds": oracle_s, "device": smi})
    require(res.rc == 0, "stream_main pagerank: failed")
    require(bool(np.isfinite(res.ranks).all()) and res.ranks.shape == (gs.nv,),
            "stream_main pagerank: ranks not finite or misshaped")
    require(rel <= RANK_RTOL, f"stream_main pagerank: ranks off the f64 oracle by {rel}")
    require(st.n_chunks >= STREAM_MIN_CHUNKS,
            f"stream_main: {st.n_chunks} chunks a part, fewer than {STREAM_MIN_CHUNKS}")
    require(peak <= st.budget_bytes,
            f"stream_main pagerank: peak {peak} bytes over the budget {st.budget_bytes}")
    require(counts["mxscan_segmented"] >= ITERS * st.n_chunks,
            f"stream_main: mxscan launched {counts['mxscan_segmented']} times")
    del res, st, ssh, s0, on_off, buf, rows_host, xfer, chunk, full, vals, labels
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = counted(kernels, cc_app.run, argv + ["-check"], graph=gs)
    peak = torch.cuda.max_memory_allocated() - base_mem
    launches["components"] = counts
    st = res.streamed
    off, _ = stream.run_pull_until_streamed(
        cc_model.MaxLabelProgram(), st.layout,
        pull.init_state(cc_model.MaxLabelProgram(), to_device(st.layout.varrays, dev)),
        10_000, cc_model.active_count, "mxscan", prefetch=False)
    off = st.layout.scatter_to_global(off.cpu().numpy())
    st.layout = None
    torch.cuda.empty_cache()
    resident = cc_model.connected_components(gs, method="mxscan", device=dev)
    emit({"phase": "stream_main", "app": "components", "rc": res.rc, "iters": res.iters,
          "chunks_per_part": st.n_chunks, "chunk_edges": st.chunk_e,
          "ms_per_iter": res.seconds * 1e3 / res.iters, "peak_bytes": peak,
          "budget_bytes": st.budget_bytes, "estimate_bytes": st.resident_bytes,
          "launches": counts, "wall_seconds": wall,
          "seconds": time.perf_counter() - t0, "device": smi})
    require(res.rc == 0, "stream_main components: -check failed")
    require(peak <= st.budget_bytes,
            f"stream_main components: peak {peak} bytes over the budget {st.budget_bytes}")
    require(np.array_equal(res.state, resident),
            "stream_main components: labels differ from the resident run")
    require(np.array_equal(off, res.state), "stream_main components: prefetch off differs")
    return launches, rows


def ckpt_main(np, kernels, smi, tmp, g, gw, hub, pr_ranks, delta_whole, cc_whole):
    """Phase 16: runs cut and resumed from their checkpoints, bitwise the
    uninterrupted runs: PageRank --ckpt-every CKPT_PR_EVERY, run to
    ITERS/2 then resumed to ITERS (against phase 6's mxscan run); SSSP
    --delta DELTA_WIDTHS[0] --ckpt-every CKPT_DELTA_EVERY, cut at half its
    rounds (against phase 13's run); components --ckpt-every
    CKPT_CC_EVERY, cut at half its iterations (against phase 10's mxscan
    run).  The seconds a save takes and its bytes on disk.  Returns
    {app: launches of the resumed run}."""
    from lux_tpu_torch.apps import components as cc_app
    from lux_tpu_torch.apps import pagerank as pr_app
    from lux_tpu_torch.apps import sssp as sssp_app
    from lux_tpu_torch.utils import checkpoint

    t0 = time.perf_counter()
    launches = {}
    common = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0",
              "--method", "mxscan", "--device", "cuda"]
    d_pr, d_d, d_cc, d_t = (os.path.join(tmp, n) for n in ("ck_pr", "ck_delta", "ck_cc", "ck_t"))
    half = ITERS // 2
    ck = ["--ckpt-dir", d_pr, "--ckpt-every", str(CKPT_PR_EVERY)]
    cut, _, _ = counted(kernels, pr_app.run, common + ["-ni", str(half)] + ck, graph=g)
    res, counts, wall = counted(kernels, pr_app.run, common + ["-ni", str(ITERS)] + ck, graph=g)
    launches["pagerank"] = counts
    require(cut.iters == half and res.iters == ITERS - half,
            f"ckpt_main pagerank: ran {cut.iters} + {res.iters} iterations")
    require(np.array_equal(res.ranks, pr_ranks),
            "ckpt_main pagerank: the resumed ranks differ from the uninterrupted run's")
    t1 = time.perf_counter()
    path = checkpoint.save_iteration(d_t, ITERS, res.ranks, "pagerank")
    saves = {"pagerank": {"seconds": time.perf_counter() - t1,
                          "bytes": os.path.getsize(path)}}
    emit({"phase": "ckpt_main", "app": "pagerank", "every": CKPT_PR_EVERY,
          "cut_at": half, "resumed_iters": res.iters, "ms": res.seconds * 1e3,
          "files": sorted(os.listdir(d_pr)), "launches": counts, "wall_seconds": wall,
          "save": saves["pagerank"], "device": smi})
    wbase = ["--weighted", "-start", str(hub), "--delta", str(DELTA_WIDTHS[0]),
             "--ckpt-dir", d_d, "--ckpt-every", str(CKPT_DELTA_EVERY)]
    for name, mod, graph, extra, whole, d in (
            ("sssp-delta", sssp_app, gw, wbase, delta_whole, d_d),
            ("components", cc_app, g,
             ["--ckpt-dir", d_cc, "--ckpt-every", str(CKPT_CC_EVERY)], cc_whole, d_cc)):
        stop = max(whole.iters // 2, 1)
        cut, _, _ = counted(kernels, mod.run, common + extra + ["--max-iters", str(stop)],
                            graph=graph)
        res, counts, wall = counted(kernels, mod.run, common + extra + ["-check"],
                                    graph=graph)
        launches[name] = counts
        files = sorted(os.listdir(d), key=lambda f: int(f[5:-4]))
        t1 = time.perf_counter()
        if name == "sssp-delta":
            path = checkpoint.save_delta(d_t, 1, res.state, res.state < (1 << 30),
                                         res.traversed, 0, "sssp")
        else:
            path = checkpoint.save_frontier(d_t, 1, res.state, np.ones(g.nv, bool),
                                            res.traversed, name)
        saves[name] = {"seconds": time.perf_counter() - t1, "bytes": os.path.getsize(path)}
        emit({"phase": "ckpt_main", "app": name, "cut_at": cut.iters,
              "iters": res.iters, "traversed_edges": res.traversed,
              "ms": res.seconds * 1e3, "checkpoints": len(files), "last": files[-1],
              "launches": counts, "wall_seconds": wall, "save": saves[name], "device": smi})
        require(cut.iters == stop, f"ckpt_main {name}: the cut run stopped at {cut.iters}")
        require(res.rc == 0, f"ckpt_main {name}: -check failed")
        require(np.array_equal(res.state, whole.state),
                f"ckpt_main {name}: the resumed state differs from the uninterrupted run's")
        require((res.iters, res.traversed) == (whole.iters, whole.traversed),
                f"ckpt_main {name}: iterations or edges differ from the uninterrupted run")
    emit({"phase": "ckpt_main", "seconds": time.perf_counter() - t0})
    return launches


def serve_oracles(scale: int):
    """The serving phase's host oracles on the main graph: the query
    vertices the --serve driver draws (serve/benchmarks.pick_sources,
    seed 0), scipy's BFS distances (INF == nv) from the first SERVE_BFS
    and the float64 personalized PageRank (models/pagerank.ppr_reference,
    ITERS iterations) of the first SERVE_PPR, and seconds.  Runs in a
    spawned process while the card works."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models.pagerank import ppr_reference
    from lux_tpu_torch.serve.benchmarks import pick_sources

    g = generate.rmat(scale, EF, seed=0)
    t0 = time.perf_counter()
    src = pick_sources(g, SERVE_APP_Q, seed=0)
    adj = csr_matrix((np.ones(g.ne), (g.col_idx, g.dst_of_edges())), shape=(g.nv, g.nv))
    d = shortest_path(adj, directed=True, unweighted=True, indices=src[:SERVE_BFS])
    dist = np.where(np.isinf(d), g.nv, d).astype(np.int32)
    ppr = [ppr_reference(g, int(v), ITERS) for v in src[:SERVE_PPR]]
    return src, dist, ppr, time.perf_counter() - t0


def serve_split(torch, np, g, sh, dev, sources, reps: int = 3) -> dict:
    """Milliseconds of one batched SSSP iteration's steps at Q = SERVE_Q
    on the main layout (serve/batched._batched_part: the (E, Q) gather,
    the edge function, the segmented min of every lane, the apply), per
    reduce method of SERVE_METHODS' resolution (the plain scan that
    mxscan falls back to on (E, Q) values, and scatter), from the
    initial state of ``sources``; CUDA events, ``reps`` launches each
    after warm-up.  The methods' minima must be bitwise equal."""
    from lux_tpu_torch.graph.shards import to_device
    from lux_tpu_torch.ops import segment
    from lux_tpu_torch.serve import batched

    prog = batched.make_program("sssp", g.nv)
    arr = to_device(sh.arrays, dev).part(0)
    q = torch.from_numpy(np.asarray(sources, np.int32)).to(dev)
    loc = prog.init_part(arr.global_vid, arr.degree, arr.vtx_mask, q)
    src = loc.index_select(0, arr.src_pos)
    vals = prog.edge_value(src, arr.weights)
    out, accs = {}, {}
    for method in ("scan", "scatter"):
        def reduce(m=method):
            return segment.segment_min_csc(vals, arr.row_ptr, arr.head_flag, arr.dst_local,
                                           method=m)
        accs[method] = reduce()
        out[method] = {
            "gather": time_ms(torch, lambda: loc.index_select(0, arr.src_pos), reps, 1),
            "edge": time_ms(torch, lambda: prog.edge_value(src, arr.weights), reps, 1),
            "reduce": time_ms(torch, reduce, reps, 1),
            "apply": time_ms(torch, lambda: prog.apply(loc, accs["scan"], arr, q), reps, 1)}
    require(torch.equal(accs["scan"], accs["scatter"]),
            "serve_split: the scan's and scatter's lane minima differ")
    return out


def serve_main(torch, np, kernels, smi, dev, g, sh, serve_oracle):
    """Phase 17: the batched query service on the main graph, through the
    apps' library entry with the graph built above: `apps.sssp --serve
    --serve-queries SERVE_APP_Q --serve-buckets SERVE_BUCKETS -check` and
    `apps.pagerank --serve -ni ITERS --serve-queries SERVE_APP_Q
    --serve-buckets SERVE_BUCKETS -check`, each
    summary (QPS, latency percentiles, batch occupancy, warm hit ratio)
    with the estimate and the peak memory; every SSSP answer 0 at its
    source with no triangle-inequality violation (the driver's -check),
    the first SERVE_BFS bitwise scipy's BFS and the first SERVE_PPR within
    rtol 1e-4 of the float64 oracle (the pool).  Then
    serve/benchmarks.measure_serving with bench.py's serving-row
    arguments under each of SERVE_METHODS, and one batched iteration's
    steps timed (serve_split).  Every launch counter is set to 0 at the
    phase's start and read at its end: returns them, and (sources, SSSP
    answers, PPR answers) of the two app runs."""
    from lux_tpu_torch.apps import pagerank as pr_app
    from lux_tpu_torch.apps import sssp as sssp_app
    from lux_tpu_torch.serve.batched import resolve_method
    from lux_tpu_torch.serve.benchmarks import measure_serving, pick_sources
    from lux_tpu_torch.utils import preflight

    t0 = time.perf_counter()
    for k in kernels.values():
        k.launches = 0
    base = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0",
            "--device", "cuda", "--serve", "--serve-queries", str(SERVE_APP_Q), "-check",
            "--serve-buckets", SERVE_BUCKETS]
    runs = {}
    for app, mod, extra in (("sssp", sssp_app, []), ("ppr", pr_app, ["-ni", str(ITERS)])):
        t1 = time.perf_counter()
        res = mod.run(base + extra, graph=g)
        runs[app] = res
        s = res.summary
        emit({"phase": "serve_main", "app": app, "argv": extra, "rc": res.rc,
              "method": res.method, "qps": s["qps"], "latency_ms": s["latency_ms"],
              "queue_wait_ms": s["queue_wait_ms"], "batches": s["batches"],
              "batch_occupancy": s["batch_occupancy"],
              "warm_hit_ratio": s["engine_cache"]["warm_hit_ratio"],
              "warm_seconds": s["engine_cache"]["warm_seconds"],
              "completed": s["completed"], "traversed_edges": s["traversed_edges"],
              "gteps_aggregate": s["gteps_aggregate"], "estimate_bytes": res.estimate_bytes,
              "peak_bytes": res.peak_bytes, "wall_seconds": time.perf_counter() - t1,
              "device": smi})
        require(res.rc == 0, f"serve_main {app}: -check failed")
        require(res.peak_bytes <= res.estimate_bytes,
                f"serve_main {app}: peak {res.peak_bytes} B over the printed estimate "
                f"{res.estimate_bytes} B")
        require(s["completed"] == SERVE_APP_Q and s["timeouts"] == 0,
                f"serve_main {app}: {s['completed']} of {SERVE_APP_Q} answered")
        require(all(a is not None and a.shape == (g.nv,) for a in res.answers),
                f"serve_main {app}: an answer is missing or misshaped")
    ss, pp = runs["sssp"], runs["ppr"]
    for i, (v, a) in enumerate(zip(ss.sources, ss.answers)):
        require(a[int(v)] == 0, f"serve_main sssp: answer {i} is not 0 at its source {v}")
    require(all(np.isfinite(a).all() for a in pp.answers), "serve_main ppr: ranks not finite")
    o_src, o_dist, o_ppr, oracle_s = serve_oracle.result(timeout=900)
    require(np.array_equal(o_src, ss.sources) and np.array_equal(o_src, pp.sources),
            "serve_main: the oracle's query vertices differ from the driver's")
    for i in range(SERVE_BFS):
        require(np.array_equal(ss.answers[i], o_dist[i]),
                f"serve_main sssp: answer {i} (source {o_src[i]}) differs from scipy's BFS")
    ppr_err = []
    for i in range(SERVE_PPR):
        got, want = pp.answers[i].astype(np.float64), o_ppr[i].astype(np.float64)
        diff = np.abs(got - want)
        bad = int((diff > RANK_RTOL * np.abs(want) + F32_TINY).sum())
        ppr_err.append(float((diff / np.maximum(np.abs(want), F32_TINY)).max()))
        require(bad == 0, f"serve_main ppr: answer {i} (seed {o_src[i]}) off the float64 "
                          f"oracle at {bad} vertices (rtol {RANK_RTOL})")
    emit({"phase": "serve_main", "oracle": "scipy.sparse.csgraph BFS, float64 PPR",
          "bfs_checked": SERVE_BFS, "ppr_checked": SERVE_PPR, "ppr_max_rel_err": ppr_err,
          "sssp_max_dist": int(max(int(a[a < g.nv].max()) for a in ss.answers)),
          "oracle_seconds": oracle_s})
    # phase 20's yardstick: the in-process engines' answers, under auto
    served = (np.asarray(ss.sources), list(ss.answers), list(pp.answers))
    del runs, ss, pp
    torch.cuda.empty_cache()
    for method in SERVE_METHODS:
        # the service's own peak (what the card held before is not its)
        # against the batched estimate the driver prints
        est = preflight.estimate_batched(
            sh.spec, SERVE_Q, resolve_method(method, "sssp", g.nv, dev)).total_bytes
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        res = measure_serving(g, sh, app="sssp", q=SERVE_Q, num_seq=4, batched_reps=1,
                              method=method, device=dev)
        peak = int(torch.cuda.max_memory_allocated(dev)) - base
        emit({"phase": "serve_main", "measure_serving": method, "peak_bytes": peak,
              "estimate_bytes": est, "wall_seconds": time.perf_counter() - t1,
              "device": smi, **res})
        require(peak <= est, f"serve_main measure_serving {method}: peak {peak} B over the "
                             f"estimate {est} B")
        require(res["scheduler"]["completed"] == SERVE_Q and res["scheduler"]["timeouts"] == 0,
                f"serve_main measure_serving {method}: the burst was not fully answered")
        require(res["qps_batched"] > 0 and res["qps_q1_sequential"] > 0,
                f"serve_main measure_serving {method}: no throughput")
        torch.cuda.empty_cache()
    emit({"phase": "serve_main", "q": SERVE_Q, "split_ms": serve_split(
        torch, np, g, sh, dev, pick_sources(g, SERVE_Q, seed=0)), "device": smi})
    torch.cuda.empty_cache()
    counts = {name: k.launches for name, k in kernels.items()}
    emit({"phase": "serve_main", "launches": counts, "seconds": time.perf_counter() - t0})
    return counts, served


MUTATE_PARTS = 8  # the reference's refresh row runs 8 parts (bench.py:1155)
MUTATE_CONFINED = 256  # the confined churn: deletes (and as many inserts) in one part
MUTATE_PART = 3  # ... that part's destination range
MUTATE_ATOL = 1e-6  # fused-pf / fused-mx refresh against the direct one (test_mutate.py)


def graph_sha(g) -> str:
    """A fingerprint of a graph's CSC arrays in their order: the same for
    two graphs built by one deterministic definition (the delta-log's
    merged graph), unlike edge_sha, which any edge order shares."""
    import hashlib

    h = hashlib.sha1(g.row_ptr.tobytes())
    h.update(g.col_idx.tobytes())
    return h.hexdigest()


def edge_sha(np, g) -> str:
    """A fingerprint of a graph's edge multiset, whatever the order of
    equal edges within a destination."""
    import hashlib

    key = g.dst_of_edges().astype(np.int64) * g.nv + np.asarray(g.col_idx, np.int64)
    return hashlib.sha1(np.sort(key).tobytes()).hexdigest()


def mutate_churn(np, g, cur):
    """The 1 % churn of the reference's refresh row (bench.py:1162,
    1180-1190) against ``cur``, the graph after its one-edge warm-up
    batch: k = ne // 200 distinct edges of ``cur`` deleted, then k inserts
    with uniform endpoints, drawn with default_rng(0).  Returns the two
    deleted positions in ``cur``, the two batches' (src, dst) and k."""
    k = g.ne // 200
    rng = np.random.default_rng(0)
    dele = rng.choice(cur.ne, size=k, replace=False)
    deletes = (np.asarray(cur.col_idx)[dele], cur.dst_of_edges()[dele])
    inserts = (rng.integers(0, g.nv, k), rng.integers(0, g.nv, k))
    return dele, deletes, inserts, k


def mutate_oracles(scale: int):
    """The dynamic-graph phase's host oracles, built independently of the
    delta-log: the main graph plus the warm-up edge (0, 1), the churn's
    deletes removed BY POSITION and its inserts appended, through
    from_edge_list.  Returns the merged graph's edge fingerprint, scipy's
    BFS distances (INF == nv) from the largest out-degree and from the
    first SERVE_BFS serving sources, the max-label fixpoint, the float64
    PageRank fixpoint (60 iterations of an alpha = 0.15 contraction) and
    seconds.  Runs in a spawned process while the card works."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.csc import from_edge_list
    from lux_tpu_torch.models.components import fixpoint_labels
    from lux_tpu_torch.models.pagerank import _host_iteration
    from lux_tpu_torch.serve.benchmarks import pick_sources

    g = generate.rmat(scale, EF, seed=0)
    t0 = time.perf_counter()
    cur = from_edge_list(np.append(np.asarray(g.col_idx, np.int64), 0),
                         np.append(g.dst_of_edges().astype(np.int64), 1), g.nv)
    dele, _, inserts, _ = mutate_churn(np, g, cur)
    keep = np.ones(cur.ne, bool)
    keep[dele] = False
    merged = from_edge_list(
        np.concatenate([np.asarray(cur.col_idx, np.int64)[keep], inserts[0]]),
        np.concatenate([cur.dst_of_edges().astype(np.int64)[keep], inserts[1]]), g.nv)
    start = int(np.argmax(np.bincount(g.col_idx, minlength=g.nv)))
    sources = pick_sources(g, SERVE_APP_Q, seed=0)[:SERVE_BFS]
    adj = csr_matrix((np.ones(merged.ne), (merged.col_idx, merged.dst_of_edges())),
                     shape=(g.nv, g.nv))
    d = shortest_path(adj, directed=True, unweighted=True,
                      indices=[start] + [int(v) for v in sources])
    dist = np.where(np.isinf(d), g.nv, d).astype(np.int32)
    labels = fixpoint_labels(merged)
    deg = merged.out_degrees().astype(np.float64)
    pr = np.where(deg > 0, (1.0 / g.nv) / np.maximum(deg, 1.0), 1.0 / g.nv)
    for _ in range(60):
        pr = _host_iteration(merged, pr, deg)
    return {"sha": edge_sha(np, merged), "start": start, "sources": sources,
            "dist": dist, "labels": labels, "pr": pr, "ne": merged.ne,
            "seconds": time.perf_counter() - t0}


def ulp_diff(np, a, b) -> int:
    """The largest distance in units in the last place between two f32
    arrays of non-negative values."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max()) if ai.size else 0


def rel_err(np, got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), F32_TINY)))


def best_of2(torch, fn, walls=None):
    """(best wall seconds of two calls, both results): each call ends
    with a synchronize.  ``walls`` (a list) collects both calls' seconds."""
    best, outs = float("inf"), []
    for _ in range(2):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        best = min(best, wall)
        if walls is not None:
            walls.append(wall)
        outs.append(out)
    return best, outs


def max_plan(plan):
    """A sum plan of a fused family relabelled for the max reduce: the
    routes, group layout and rank tiles do not depend on the reduce (the
    planner reads it into the static only), so the max-label checks reuse
    phase 4's plans instead of planning twice more."""
    static, arrays = plan
    if not hasattr(static, "reduce"):  # an expand plan reads no reduce
        return plan
    mx = static.mx if static.mx is None else dataclasses.replace(static.mx, op="max")
    return dataclasses.replace(static, reduce="max", mx=mx), arrays


def mutate_routed(torch, np, kernels, dev, g, sh, plans, batches):
    """The routed refresh on the main one-part layout with phase 4's BASE
    plans (expand-pf, fused-pf, fused-mx): the same churn in a one-part
    MutableGraph; PageRank refreshed direct and under each plan (expand-pf
    bitwise the direct one, the fused families within MUTATE_ATOL); three
    overlay iterations of the max-label step under each plan bitwise equal
    to each other and to the cold merged-graph step; and each kernel's
    launches in one PageRank iteration with the overlay and without,
    which must be equal.  Returns (record, the MutableGraph, its overlay)."""
    from lux_tpu_torch.engine import pull
    from lux_tpu_torch.graph.shards import build_pull_shards, to_device
    from lux_tpu_torch.models.components import MaxLabelProgram
    from lux_tpu_torch.models.pagerank import PageRankProgram
    from lux_tpu_torch.mutate import MutableGraph, refresh

    t0 = time.perf_counter()
    mg = MutableGraph(g, num_parts=1, cap=max(1024, g.ne // 200 + 128))
    require(np.array_equal(mg.pull_shards.arrays.src_pos, sh.arrays.src_pos),
            "mutate: the one-part layout is not the one phase 4 planned")
    _, arr = mg.device_pull(dev)
    pr0, _ = refresh.converge_pagerank(mg.pull_shards, device=dev, arrays=arr)
    for b in batches:
        mg.apply(*b)
    ov = mg.pull_overlay()
    rec = {"scale": SCALE, "parts": 1, "prior_seconds": time.perf_counter() - t0}
    direct, it = refresh.refresh_pagerank(mg, pr0, device=dev)
    rec["iters"] = {"direct": it}
    for fam in ("expand-pf", "fused-pf", "fused-mx"):
        got, it = refresh.refresh_pagerank(mg, pr0, route=plans[fam], device=dev)
        rec["iters"][fam] = it
        diff = float((got - direct).abs().max())
        rec[f"{fam}_max_abs_diff"] = diff
        if fam == "expand-pf":
            require(torch.equal(got, direct),
                    "mutate: PageRank refresh under expand-pf differs from the direct one")
        else:
            require(diff <= MUTATE_ATOL, f"mutate: PageRank refresh under {fam} off the "
                                         f"direct one by {diff} (atol {MUTATE_ATOL})")
    merged = mg.log.merged_graph()
    sh_m = build_pull_shards(merged, 1, cuts=np.asarray(mg.pull_shards.cuts))
    arr_m = to_device(sh_m.arrays, dev)
    lab = MaxLabelProgram()
    cold = pull.run_pull_fixed(lab, sh_m.spec, arr_m, pull.init_state(lab, arr_m), 3)
    cold = sh_m.scatter_to_global(cold.cpu().numpy())
    del arr_m, sh_m, merged
    for fam in ("expand-pf", "fused-pf", "fused-mx"):
        got = pull.run_pull_fixed(lab, mg.pull_shards.spec, arr, pull.init_state(lab, arr), 3,
                                  route=max_plan(plans[fam]), overlay=ov)
        require(np.array_equal(mg.pull_shards.scatter_to_global(got.cpu().numpy()), cold),
                f"mutate: three max-label overlay iterations under {fam} differ from the "
                "cold merged-graph step")
    # the overlay launches no kernel of its own (the reference's LUX-J503)
    prog = PageRankProgram(nv=g.nv)
    s0 = pull.init_state(prog, arr)
    launches = {}
    for fam in ("direct", "expand-pf", "fused-pf", "fused-mx"):
        route = None if fam == "direct" else plans[fam]
        pair = []
        for overlay in (None, ov):
            before = {n: kn.launches for n, kn in kernels.items()}
            pull.run_pull_fixed(prog, mg.pull_shards.spec, arr, s0, 1, route=route,
                                overlay=overlay)
            pair.append({n: kn.launches - before[n] for n, kn in kernels.items()})
        require(pair[0] == pair[1], f"mutate: one {fam} iteration launches {pair[1]} with the "
                                    f"overlay, {pair[0]} without")
        launches[fam] = pair[1]
    rec["launches_per_iteration"] = launches
    rec["seconds"] = time.perf_counter() - t0
    return rec, mg, ov


def mutate_kernel_cases(torch, np, scan, shuffle, expand, dev, mg, ov, plans, reps):
    """The four kernels of the refresh path on the overlay's inputs, at the
    main one-part layout: mxscan_segmented on tombstone-masked values
    (f32 sum against float64 segment sums, int32 max bitwise the plain
    version); mxreduce_pass_gather with tombstoned ranks sent to v_blk in
    the middle of tiles (f32 sum against float64, int32 max bitwise) and
    timed; and every expand-pf, fused-pf and fused-mx replay with the
    tombstones (fused_pass_gather, lane_gather, mxreduce) bitwise its run
    with the kernels swapped for their plain versions on the same card
    (int32 max-label values).  Returns {kernel: max_abs_err} and the mx
    timing row."""
    from lux_tpu_torch.mutate import overlay as ovl

    sh = mg.pull_shards
    rng = np.random.default_rng(18)
    del_val = torch.from_numpy(ov[1].del_val[0]).to(dev)
    full = torch.from_numpy(rng.random(sh.spec.gathered_size, dtype=np.float32) + 0.01).to(dev)
    ifull = torch.from_numpy(rng.integers(0, 1 << 30, sh.spec.gathered_size)
                             .astype(np.int32)).to(dev)
    src_pos = torch.from_numpy(sh.arrays.src_pos[0]).to(dev)
    row_ptr = torch.from_numpy(sh.arrays.row_ptr[0]).to(dev)
    head = torch.from_numpy(sh.arrays.head_flag[0]).to(dev)
    err = {}
    # mxscan on masked values
    vals = ovl.mask_deleted(full.index_select(0, src_pos), del_val, "sum")
    got = scan.mxscan_segmented(vals, head, op="sum", valid_end=row_ptr[-1:])
    nz = row_ptr[1:] > row_ptr[:-1]
    ends = (row_ptr[1:].long() - 1).clamp(min=0)
    cs = torch.zeros(vals.numel() + 1, dtype=torch.float64, device=dev)
    torch.cumsum(vals.double(), 0, out=cs[1:])
    want = cs[row_ptr[1:].long()] - cs[row_ptr[:-1].long()]
    err["mxscan_segmented"] = compare(torch, got[ends][nz], want[nz], exact=False,
                                      what="mutate: mxscan on tombstone-masked f32 values")
    ivals = ovl.mask_deleted(ifull.index_select(0, src_pos), del_val, "max")
    got = scan.mxscan_segmented(ivals, head, op="max", valid_end=row_ptr[-1:])
    want = scan.mxscan_segmented_plain(ivals, head, op="max", valid_end=row_ptr[-1:])
    m = int(row_ptr[-1])
    compare(torch, got[:m], want[:m], exact=True, what="mutate: mxscan on masked int32 max")
    # mxreduce with tombstoned ranks
    static, arrays = expand.plan_to_device(plans["fused-mx"], dev)
    part = tuple(a[0] for a in arrays)
    *_, gslot, _, mxa = expand.split_fused_arrays(static, part, static.weighted)
    mxg = static.mx
    k = len(mxg.steps)
    idx, dst_rel, tile_block = mxa[:k], mxa[k], mxa[k + 1]
    g_del = torch.zeros(static.n2 + 1, dtype=torch.bool, device=dev)
    g_del[gslot.long()] = del_val
    rel = dst_rel.masked_fill(g_del[: static.n2].view(dst_rel.shape), mxg.v_blk)
    total = sum(c for _, c, _ in static.groups)
    xf = torch.from_numpy(rng.random(static.n2, dtype=np.float32) + 0.01).to(dev)
    xi = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, static.n2, dtype=np.int64)
                          .astype(np.int32)).to(dev)
    mx_err = 0.0
    for op, x in (("sum", xf), ("max", xi)):
        g = dataclasses.replace(mxg, op=op)
        y = shuffle._relayout(x, g.view, g.perm_axes).reshape(g.kshape)
        got = shuffle.mxreduce_pass_gather(y, idx, rel, tile_block, g)
        exact = op == "max"
        want = (shuffle.mxreduce_pass_gather_plain(y, idx, rel, tile_block, g) if exact
                else mx_sum_f64(torch, shuffle, y, idx, rel, tile_block, g))
        torch.cuda.synchronize()
        mx_err = max(mx_err, compare(torch, got[:total], want[:total], exact,
                                     what=f"mutate: mx {op} with tombstoned ranks"))
        if not exact:
            mx_row = {"tombstoned_slots": int(g_del[: static.n2].sum()),
                      "kernel_ms": time_ms(torch, lambda: shuffle.mxreduce_pass_gather(
                          y, idx, rel, tile_block, g), reps),
                      "plain_ms": time_ms(torch, lambda: shuffle.mxreduce_pass_gather_plain(
                          y, idx, rel, tile_block, g), max(2, reps // 4))}
    err["mxreduce_pass_gather"] = mx_err
    # the whole tombstoned replays, kernels against their plain versions
    names = ("lane_gather", "fused_pass_gather", "mxreduce_pass_gather")
    real = {n: getattr(shuffle, n) for n in names}

    def replays():
        out = {}
        for fam in ("expand-pf", "fused-pf", "fused-mx"):
            st, arrs = expand.plan_to_device(max_plan(plans[fam]), dev)
            p0 = tuple(a[0] for a in arrs)
            if fam == "expand-pf":
                out[fam] = expand.apply_expand(ifull, st, p0)
            else:
                out[fam] = expand.apply_fused(ifull, st, p0, del_val=del_val)
        torch.cuda.synchronize()
        return out

    with_kernels = replays()
    try:
        for n in names:
            setattr(shuffle, n, getattr(shuffle, f"{n}_plain"))
        plain = replays()
    finally:
        for n, fn in real.items():
            setattr(shuffle, n, fn)
    for fam, got in with_kernels.items():
        require(torch.equal(got, plain[fam]),
                f"mutate: the tombstoned {fam} replay differs with the plain kernels")
    for n in ("lane_gather", "fused_pass_gather"):
        err[n] = 0.0
    return err, mx_row


def mutate_main(torch, np, kernels, smi, dev, g, tmp, mutate_oracle, routed, reps):
    """Phase 18: dynamic graphs on the main graph (the reference's
    ``*_refresh_churn1pct_*`` row, bench.py:1130-1330), at MUTATE_PARTS
    parts stacked on the card.  Priors (PageRank by converge_pagerank,
    SSSP from the largest out-degree, components), a one-edge warm-up
    batch refreshed, then the 1 % churn (mutate_churn) applied as two
    batches; the three refreshes timed best of two, the two runs bitwise
    equal; batched SSSP serving (Q = SERVE_APP_Q, scatter) through a
    WarmEngineCache holding the overlay, with the scheduler; compaction
    (snapshot + invalidation report); the cold legs: read_lux of the
    snapshot, the shard builds with the same cuts, the expand-pf plan
    through the cached planner on an empty cache (built) and again
    (loaded), the cold runs; the gates against the oracles of the pool
    (mutate_oracles); the churn confined to one part (invalidated
    fraction 1 / MUTATE_PARTS, its plan rebuild from the warm cache); the
    routed refresh on the one-part layout with phase 4's plans
    (mutate_routed).  Every launch counter is set to 0 at the start and
    read after mutate_routed; then mutate_kernel_cases holds the four
    kernels against their plain versions on the overlay's inputs.
    ``routed`` = (graph, one-part shards, plans).  Returns (launches,
    {kernel: max_abs_err}, record)."""
    from lux_tpu_torch import obs
    from lux_tpu_torch.engine import push
    from lux_tpu_torch.graph.format import read_lux
    from lux_tpu_torch.graph.push_shards import build_push_shards
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.models.components import MaxLabelProgram
    from lux_tpu_torch.models.sssp import SSSPProgram
    from lux_tpu_torch.mutate import OP_DELETE, OP_INSERT, MutableGraph, refresh
    from lux_tpu_torch.ops import expand, scan, shuffle
    from lux_tpu_torch.serve import batched
    from lux_tpu_torch.serve.benchmarks import pick_sources
    from lux_tpu_torch.serve.scheduler import MicroBatchScheduler
    from lux_tpu_torch.serve.warm import WarmEngineCache

    t_phase = time.perf_counter()
    for kn in kernels.values():
        kn.launches = 0
    P = MUTATE_PARTS
    snap = os.path.join(tmp, "mutate.lux")
    cache_dir = os.path.join(tmp, "plans")
    # the plan cache's default directory too (the compaction's
    # invalidation report derives its entry paths there)
    os.environ["LUX_TORCH_PLAN_CACHE"] = cache_dir
    mg = MutableGraph(g, num_parts=P, snapshot=snap, cap=max(1024, g.ne // 200 + 128))
    t0 = time.perf_counter()
    pshards = mg.push_shards
    mg.device_push(dev)
    layout_s = time.perf_counter() - t0
    start = int(np.argmax(np.bincount(g.col_idx, minlength=g.nv)))
    t0 = time.perf_counter()
    st, _, _ = push.run_push(SSSPProgram(nv=g.nv, start=start), pshards, device=dev)
    dist = pshards.scatter_to_global(st.cpu().numpy())
    st, _, _ = push.run_push(MaxLabelProgram(), pshards, device=dev)
    labels = pshards.scatter_to_global(st.cpu().numpy())
    pr, pr_it = refresh.converge_pagerank(mg.pull_shards, device=dev,
                                          arrays=mg.device_pull(dev)[1])
    priors_s = time.perf_counter() - t0
    mg.apply([0], [1], [OP_INSERT])  # the warm-up batch (bench.py:1174)
    t0 = time.perf_counter()
    pr, _ = refresh.refresh_pagerank(mg, pr, device=dev)
    dist, _ = refresh.refresh_sssp(mg, dist, start, device=dev)
    labels, _ = refresh.refresh_components(mg, labels, device=dev)
    warmup_s = time.perf_counter() - t0
    _, deletes, inserts, k = mutate_churn(np, g, mg.log.merged_graph())
    t0 = time.perf_counter()
    mg.apply(*deletes, np.full(k, OP_DELETE, np.int8))
    mg.apply(*inserts, np.full(k, OP_INSERT, np.int8))
    apply_s = time.perf_counter() - t0
    occ = mg.occupancy()
    emit({"phase": "mutate_main", "scale": SCALE, "parts": P, "churn_edges": 2 * k,
          "cap": mg.cap, "layout_seconds": layout_s, "priors_seconds": priors_s,
          "prior_pagerank_iters": pr_it, "warmup_refresh_seconds": warmup_s,
          "apply_s": apply_s, "delta_occupancy": occ})
    # the warm refreshes, best of two; two runs from one prior bitwise
    # equal; the recorder's mutate.refresh spans against the measured
    # seconds of the same six calls
    refresh_s, iters, walls = {}, {}, []
    rec = obs.recorder()
    span_s0, span_n0 = rec.total_seconds("mutate.refresh"), rec.total_count("mutate.refresh")
    refresh_s["pagerank"], (a, b) = best_of2(
        torch, lambda: refresh.refresh_pagerank(mg, pr, device=dev), walls)
    require(torch.equal(a[0], b[0]) and a[1] == b[1],
            "mutate: two PageRank refreshes from one prior differ")
    pr_warm, iters["pagerank"] = mg.pull_shards.scatter_to_global(a[0].cpu().numpy()), a[1]
    refresh_s["sssp"], (a, b) = best_of2(
        torch, lambda: refresh.refresh_sssp(mg, dist, start, device=dev), walls)
    require(np.array_equal(a[0], b[0]), "mutate: two SSSP refreshes from one prior differ")
    dist_warm, iters["sssp"] = a
    refresh_s["components"], (a, b) = best_of2(
        torch, lambda: refresh.refresh_components(mg, labels, device=dev), walls)
    require(np.array_equal(a[0], b[0]), "mutate: two CC refreshes from one prior differ")
    labels_warm, iters["components"] = a
    span_s = rec.total_seconds("mutate.refresh") - span_s0
    span_n = rec.total_count("mutate.refresh") - span_n0
    emit({"phase": "mutate_main", "refresh_span_seconds": span_s, "refresh_spans": span_n,
          "refresh_measured_seconds": sum(walls), "refresh_calls": len(walls)})
    require(span_n == len(walls) == 6, f"mutate: {span_n} mutate.refresh spans for "
                                       f"{len(walls)} refreshes")
    require(abs(span_s - sum(walls)) <= REFRESH_SPAN_REL * sum(walls),
            f"mutate: the mutate.refresh spans' {span_s:.4f} s are off the measured "
            f"{sum(walls):.4f} s by more than {REFRESH_SPAN_REL:.0%}")
    # the host's share: each refresh's analysis and overlay build alone
    host_s = {}
    for name, fn in (("sssp_dirty", lambda: refresh.sssp_dirty(mg, dist, start)),
                     ("cc_dirty", lambda: refresh.cc_dirty(mg, labels)),
                     ("pull_overlay", mg.pull_overlay),
                     ("push_overlay", mg.push_overlay_parts)):
        t0 = time.perf_counter()
        fn()
        host_s[name] = time.perf_counter() - t0
    # one PageRank iteration at 8 parts, with the overlay (already on the
    # card) and without: CUDA events over REPS iterations each
    from lux_tpu_torch.engine import pull
    from lux_tpu_torch.models.pagerank import PageRankProgram

    prog = PageRankProgram(nv=g.nv)
    _, arr = mg.device_pull(dev)
    spec = mg.pull_shards.spec
    ov_dev = pull.overlay_parts(mg.pull_overlay(), dev, spec)
    s0 = pull.init_state(prog, arr)
    iter_ms = {"overlay": time_ms(torch, lambda: pull.run_pull_fixed(
                   prog, spec, arr, s0, 1, overlay=ov_dev), reps),
               "base": time_ms(torch, lambda: pull.run_pull_fixed(prog, spec, arr, s0, 1), reps),
               "fold_rounds": int(ov_dev[0].rounds.shape[0])}
    del ov_dev, s0
    # serving: the overlay installed in a warm cache, through the scheduler
    t0 = time.perf_counter()
    sources = pick_sources(g, SERVE_APP_Q, seed=0)
    ostatic, oarr = mg.pull_overlay()
    cache = WarmEngineCache(mg.pull_shards, apps=("sssp",), q_buckets=(SERVE_APP_Q,),
                            method="scatter", overlay_static=ostatic, device=dev)
    cache.prewarm()
    cache.set_overlay(1, oarr)
    sched = MicroBatchScheduler(cache, app="sssp", max_wait_ms=0.0).start()
    try:
        futs = [sched.submit(int(v)) for v in sources]
        live = np.stack([f.result(timeout=600) for f in futs])
        gens = {f.generation for f in futs}
    finally:
        sched.stop()
    require(gens == {1}, f"mutate: served generations {gens}, not the installed 1")
    serve_s = time.perf_counter() - t0
    del cache, sched, futs
    torch.cuda.empty_cache()
    # compaction: the snapshot and the plan-cache invalidation
    t0 = time.perf_counter()
    rep = mg.compact(path=snap)
    compact_s = time.perf_counter() - t0
    churn_snap = os.path.join(tmp, "churn1pct.lux")  # phase 20 publishes it
    shutil.copyfile(snap, churn_snap)
    inval = rep["invalidation"]
    merged_sha = edge_sha(np, mg.base)
    cold_eng = batched.BatchedEngine(mg.pull_shards, "sssp", SERVE_APP_Q, method="scatter",
                                     device=dev)
    cold_serve = cold_eng.run(sources).state
    require(np.array_equal(live, cold_serve),
            "mutate: serving with the overlay differs from an engine on the compacted graph")
    del cold_eng
    torch.cuda.empty_cache()
    # the cold legs
    cuts = np.asarray(mg.pull_shards.cuts)
    brk = {}
    t0 = time.perf_counter()
    gc = read_lux(snap)
    brk["load"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shc = build_pull_shards(gc, P, cuts=cuts)
    brk["build_pull"] = time.perf_counter() - t0
    expand.reset_plan_stats()
    t0 = time.perf_counter()
    expand.plan_expand_shards_cached(shc, cache_dir, pf=True)
    brk["plan_build"] = time.perf_counter() - t0
    built = expand.plan_stats_snapshot()
    t0 = time.perf_counter()
    expand.plan_expand_shards_cached(shc, cache_dir, pf=True)
    brk["plan_load"] = time.perf_counter() - t0
    loaded = expand.plan_stats_snapshot()
    require(built["built"] == 2 * P and loaded["built"] == built["built"]
            and loaded["loaded"] == P,
            f"mutate: the plan cache built {built} then {loaded}")
    t0 = time.perf_counter()
    out, _ = refresh.converge_pagerank(shc, device=dev)
    pr_cold = shc.scatter_to_global(out.cpu().numpy())
    brk["compute_pagerank"] = time.perf_counter() - t0
    del shc, out
    t0 = time.perf_counter()
    shp = build_push_shards(gc, P, cuts=cuts)
    brk["build_push"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st, _, _ = push.run_push(SSSPProgram(nv=g.nv, start=start), shp, device=dev)
    dist_cold = shp.scatter_to_global(st.cpu().numpy())
    brk["compute_sssp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st, _, _ = push.run_push(MaxLabelProgram(), shp, device=dev)
    labels_cold = shp.scatter_to_global(st.cpu().numpy())
    brk["compute_components"] = time.perf_counter() - t0
    del shp, gc, st
    torch.cuda.empty_cache()
    cold = {}
    for app, build, comp in (("pagerank", "build_pull", "compute_pagerank"),
                             ("sssp", "build_push", "compute_sssp"),
                             ("components", "build_push", "compute_components")):
        base = brk["load"] + brk[build] + brk[comp]
        cold[app] = {"plan_built": base + brk["plan_build"], "plan_loaded": base + brk["plan_load"]}
    # the gates
    o = mutate_oracle.result(timeout=900)
    require(o["sha"] == merged_sha and o["start"] == start,
            "mutate: the compacted graph is not the oracle's merged graph")
    require(np.array_equal(o["sources"], sources[:SERVE_BFS]), "mutate: oracle sources differ")
    require(np.array_equal(dist_warm, dist_cold) and np.array_equal(dist_warm, o["dist"][0]),
            "mutate: warm SSSP differs from the cold rebuild or scipy's BFS")
    require(np.array_equal(labels_warm, labels_cold) and np.array_equal(labels_warm, o["labels"]),
            "mutate: warm components differ from the cold rebuild or the fixpoint")
    for i in range(SERVE_BFS):
        require(np.array_equal(live[i], o["dist"][1 + i]),
                f"mutate: served answer {i} differs from scipy's BFS on the merged graph")
    pr_err = {"warm": rel_err(np, pr_warm, o["pr"]), "cold": rel_err(np, pr_cold, o["pr"])}
    require(max(pr_err.values()) <= RANK_RTOL,
            f"mutate: PageRank off the float64 fixpoint by {pr_err} (rtol {RANK_RTOL})")
    rows = {}
    for app, warm_v, cold_v in (("pagerank", pr_warm, pr_cold), ("sssp", dist_warm, dist_cold),
                                ("components", labels_warm, labels_cold)):
        rows[app] = {"value": cold[app]["plan_built"] / refresh_s[app],
                     "value_plan_loaded": cold[app]["plan_loaded"] / refresh_s[app],
                     "refresh_s": refresh_s[app], "cold_s": cold[app]["plan_built"],
                     "cold_s_plan_loaded": cold[app]["plan_loaded"],
                     "warm_over_cold": refresh_s[app] / cold[app]["plan_built"],
                     "warm_over_cold_plan_loaded": refresh_s[app] / cold[app]["plan_loaded"],
                     "refresh_iters": int(iters[app]),
                     "bitwise_equal": bool(np.array_equal(warm_v, cold_v))}
    rows["pagerank"]["max_ulp_diff"] = ulp_diff(np, pr_warm, pr_cold)
    rows["pagerank"]["max_rel_err_vs_f64"] = pr_err
    emit({"phase": "mutate_main", "rows": rows, "cold_breakdown": brk,
          "pagerank_iteration_ms": iter_ms, "host_seconds": host_s,
          "invalidated_bucket_fraction": inval["fraction"], "invalidation": inval,
          "apply_s": apply_s, "compact_s": compact_s, "delta_occupancy": occ, "parts": P,
          "serve": {"q": SERVE_APP_Q, "method": "scatter", "seconds": serve_s,
                    "bfs_checked": SERVE_BFS},
          "plan_cache": {"build": built, "load": loaded}, "oracle_seconds": o["seconds"],
          "device": smi})
    del o, dist, labels, pr, live, cold_serve
    # a churn confined to one part's destination range
    t0 = time.perf_counter()
    lo, hi = int(cuts[MUTATE_PART]), int(cuts[MUTATE_PART + 1])
    dsts = mg.base.dst_of_edges()
    rng = np.random.default_rng(1)
    dele = rng.choice(np.flatnonzero((dsts >= lo) & (dsts < hi)), MUTATE_CONFINED,
                      replace=False)
    mg.apply(np.asarray(mg.base.col_idx)[dele], dsts[dele],
             np.full(MUTATE_CONFINED, OP_DELETE, np.int8))
    mg.apply(rng.integers(0, g.nv, MUTATE_CONFINED), rng.integers(lo, hi, MUTATE_CONFINED),
             np.full(MUTATE_CONFINED, OP_INSERT, np.int8))
    del dsts
    rep2 = mg.compact(path=snap)
    expand.reset_plan_stats()
    t1 = time.perf_counter()
    expand.plan_expand_shards_cached(mg.pull_shards, cache_dir, pf=True)
    rebuild_s = time.perf_counter() - t1
    stats = expand.plan_stats_snapshot()
    frac = rep2["invalidation"]["fraction"]
    emit({"phase": "mutate_main", "confined_part": MUTATE_PART, "churn_edges": 2 * MUTATE_CONFINED,
          "invalidation": rep2["invalidation"], "plan_rebuild_s": rebuild_s,
          "plan_stats": stats, "seconds": time.perf_counter() - t0})
    require(frac == 1.0 / P and rep2["invalidation"]["changed_parts"] == [MUTATE_PART],
            f"mutate: a churn confined to part {MUTATE_PART} invalidated {rep2['invalidation']}")
    require(stats["loaded"] == P - 1 and stats["built"] == 2,
            f"mutate: the warm cache rebuilt {stats} after the confined churn")
    del mg
    torch.cuda.empty_cache()
    # the routed refresh on the one-part layout, phase 4's plans: the same
    # batches (a rehearsal on a smaller graph draws its own churn)
    g_r, sh_r, plans = routed
    if g_r is g:
        batches = [([0], [1], [OP_INSERT]), (*deletes, np.full(k, OP_DELETE, np.int8)),
                   (*inserts, np.full(k, OP_INSERT, np.int8))]
    else:
        _, d2, i2, k2 = mutate_churn(np, g_r, g_r)
        batches = [(*d2, np.full(k2, OP_DELETE, np.int8)), (*i2, np.full(k2, OP_INSERT, np.int8))]
    rec, mg1, ov1 = mutate_routed(torch, np, kernels, dev, g_r, sh_r, plans, batches)
    counts = {name: kn.launches for name, kn in kernels.items()}
    emit({"phase": "mutate_main", "routed": rec, "device": smi})
    for name in ("mxscan_segmented", "lane_gather", "fused_pass_gather", "mxreduce_pass_gather"):
        require(counts[name] > 0, f"mutate: {name} was never launched on the refresh path")
    err, mx_row = mutate_kernel_cases(torch, np, scan, shuffle, expand, dev, mg1, ov1, plans,
                                      reps)
    emit({"phase": "mutate_main", "kernels_vs_plain": err, "mx_tombstoned": mx_row,
          "launches": counts, "seconds": time.perf_counter() - t_phase})
    return counts, err, {"rows": rows, "cold_breakdown": brk, "churn_snapshot": churn_snap}


COLD_LEAD = 3.0  # overlapped runs: iterations for this many plan loads of direct chunks
PROFILE_REL = 0.10  # the profiled run's device total against its CUDA-event time
REFRESH_SPAN_REL = 0.05  # mutate.refresh spans against the measured refresh seconds
TEL_RTOL = 1e-4  # the ring's f32 residual against its float64 recomputation
SLEEP_CYCLES = 100_000_000  # ~50 ms of torch.cuda._sleep: the host's head start
#: spans the smoke's event log must hold (phases 4, 17, 18, 19)
OBS_SPANS = ("plan.load", "plan.build", "graph.build", "pull.chunk", "serve.dispatch",
             "mutate.refresh",
             "xprof.trace", "fleet.start", "fleet.worker.start", "mutate.publish")


def obs_run_dir() -> str:
    return os.path.join(os.environ["LUX_OBS_DIR"], os.environ["LUX_OBS_RUN_ID"])


def obs_events(paths=None) -> list:
    """Every event of the smoke's run directory (all its processes), or
    of ``paths``."""
    from lux_tpu_torch import obs

    obs.recorder().flush()
    paths = paths or sorted(glob.glob(os.path.join(obs_run_dir(), "events-*.jsonl")))
    out = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            out.extend(json.loads(line) for line in f if line.strip())
    return out


def obs_spans(events, name=None, since=None) -> list:
    """Completed spans as (name, begin attrs, t0, t1, end attrs), begun at
    or after ``since`` (the monotonic clock)."""
    begins, out = {}, []
    for ev in events:
        if ev["e"] == "b":
            begins[ev["s"]] = ev
        elif ev["e"] == "e" and ev["ok"] and ev["s"] in begins:
            b = begins[ev["s"]]
            if (name is None or b["n"] == name) and (since is None or b["t"] >= since):
                out.append((b["n"], b.get("a", {}), b["t"], ev["t"], ev.get("a", {})))
    return out


def launch_dirs() -> list:
    """The launcher's private worker directories (serve/fleet/launcher:
    lux-launch-* under the temporary directory) that exist now."""
    return sorted(glob.glob(os.path.join(tempfile.gettempdir(), "lux-launch-*")))


def launch_snapshot(kernels) -> dict:
    return {name: k.launches for name, k in kernels.items()}


def launch_delta(kernels, before: dict) -> dict:
    return {name: k.launches - before[name] for name, k in kernels.items()}


def cold_app_runs(np, kernels, smi, g, plan_dir, main_pf, built_s) -> list:
    """Phase 19a: `apps.pagerank --route-gather expand-pf -ni 10 -check`
    twice on LUX_TORCH_PLAN_CACHE = phase 4's cache: both load their plan
    (the printed line, no entry built), ranks bitwise phase 6's expand-pf
    run, its lane, fused and mxscan launches equal.  Returns the load
    seconds of each run."""
    import contextlib
    import io

    from lux_tpu_torch.apps import pagerank as pr_app
    from lux_tpu_torch.ops import expand

    pf_ranks, pf_counts = main_pf
    argv = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--route-gather", "expand-pf",
            "-ni", str(ITERS), "-check"]
    old_cache = os.environ.get("LUX_TORCH_PLAN_CACHE")
    os.environ["LUX_TORCH_PLAN_CACHE"] = plan_dir
    load_s = []
    try:
        for i in range(2):
            before, st0 = launch_snapshot(kernels), expand.plan_stats_snapshot()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                res = pr_app.run(argv, graph=g)
            wall = time.perf_counter() - t0
            text = out.getvalue()
            sys.stdout.write(text)
            st1, counts = expand.plan_stats_snapshot(), launch_delta(kernels, before)
            line = [x for x in text.splitlines() if x.startswith("routed plan ")]
            load_s.append(st1["warm_s"] - st0["warm_s"])
            emit({"phase": "cold_obs", "leg": "app_plan_cache", "run": i, "argv": argv,
                  "rc": res.rc, "plan_line": line, "plan_loaded_s": load_s[-1],
                  "entries_loaded": st1["loaded"] - st0["loaded"],
                  "entries_built": st1["built"] - st0["built"],
                  "plan_built_s_phase4": built_s["expand"] + built_s["expand-pf"],
                  "launches": counts, "ms_per_iter": res.seconds * 1e3 / ITERS,
                  "wall_seconds": wall, "device": smi})
            require(res.rc == 0, f"cold app run {i}: -check failed")
            require(len(line) == 1 and line[0].startswith("routed plan loaded:")
                    and line[0].endswith(" s"), f"cold app run {i} printed {line}")
            require(st1["built"] == st0["built"] and st1["loaded"] > st0["loaded"],
                    f"cold app run {i}: built a plan entry instead of loading it")
            require(np.array_equal(res.ranks, pf_ranks),
                    f"cold app run {i}: ranks differ from phase 6's expand-pf run")
            for name in ("lane_gather", "fused_pass_gather", "mxscan_segmented"):
                require(counts[name] == pf_counts[name],
                        f"cold app run {i}: {name} launched {counts[name]} times, "
                        f"phase 6 {pf_counts[name]}")
            del res
    finally:
        if old_cache is None:
            os.environ.pop("LUX_TORCH_PLAN_CACHE", None)
        else:
            os.environ["LUX_TORCH_PLAN_CACHE"] = old_cache
    return load_s


def cold_overlapped(torch, smi, dev, sh, arrays, prog, s0, plan_dir, app_load_s):
    """Phase 19b: PageRank (mxscan) through run_pull_fixed_overlapped with
    a plan_async future loading phase 4's expand-pf plan: it hands over
    mid-run, bitwise the direct run; the time to the first iteration
    against the load, ms a synchronized direct chunk with the future
    loading (the pull.chunk spans) and alone.  A fused-pf future resolving
    mid-run finishes direct, bitwise.  The iteration counts follow the
    measured loads: COLD_LEAD loads' worth of direct chunks."""
    from lux_tpu_torch import obs
    from lux_tpu_torch.engine import pull
    from lux_tpu_torch.ops import expand

    keep = s0.clone()

    def sync_chunks_ms(n: int) -> float:
        st = s0
        t0 = time.perf_counter()
        for _ in range(n):
            st = pull.run_pull_fixed(prog, sh.spec, arrays, st, 1, "mxscan")
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3 / n

    sync_chunks_ms(20)
    chunk_ms = sync_chunks_ms(300)
    t0 = time.perf_counter()
    expand.plan_fused_shards_cached(sh, "sum", cache_dir=plan_dir, pf=True)
    fused_load_s = time.perf_counter() - t0
    n_e = max(200, int(COLD_LEAD * max(app_load_s) * 1e3 / chunk_ms))
    n_f = max(200, int(COLD_LEAD * fused_load_s * 1e3 / chunk_ms))
    ref_e = pull.run_pull_fixed(prog, sh.spec, arrays, s0, n_e, "mxscan")
    ref_f = (pull.run_pull_fixed(prog, sh.spec, arrays, ref_e, n_f - n_e, "mxscan")
             if n_f >= n_e else pull.run_pull_fixed(prog, sh.spec, arrays, s0, n_f, "mxscan"))
    rows = {}
    for fam, n, ref, build in (
            ("expand-pf", n_e, ref_e,
             lambda: expand.plan_expand_shards_cached(sh, cache_dir=plan_dir, pf=True)),
            ("fused-pf", n_f, ref_f,
             lambda: expand.plan_fused_shards_cached(sh, "sum", cache_dir=plan_dir, pf=True))):
        torch.cuda.synchronize(dev)
        st0 = expand.plan_stats_snapshot()
        t_mono, t0 = time.monotonic(), time.perf_counter()
        fut = expand.plan_async(build)
        out, routed = pull.run_pull_fixed_overlapped(prog, sh.spec, arrays, s0, n, "mxscan",
                                                     route_future=fut, chunk=1)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        fut.result()
        st1 = expand.plan_stats_snapshot()
        chunks = obs_spans(obs_events([obs.recorder().log_path]), "pull.chunk", since=t_mono)
        direct = [c for c in chunks if not c[1]["routed"] and not c[1].get("fused_skip")]
        rows[fam] = {
            "iters": n, "routed_iters": routed, "wall_seconds": wall,
            "plan_load_s": st1["warm_s"] - st0["warm_s"],
            "first_iter_s": direct[0][3] - t_mono if direct else None,
            "direct_chunks": len(direct),
            "ms_per_direct_chunk_loading": (1e3 * sum(c[3] - c[2] for c in direct) / len(direct)
                                            if direct else None),
            "ms_per_direct_chunk_alone": chunk_ms,
            "fused_skip": any(c[1].get("fused_skip") for c in chunks)}
        require(torch.equal(s0, keep), f"overlapped {fam}: the caller's state was written")
        require(torch.equal(out, ref), f"overlapped {fam}: state differs from the direct run")
        if fam == "expand-pf":
            require(0 < routed < n, f"overlapped expand-pf: routed_iters {routed} of {n}")
        else:
            require(routed == 0 and rows[fam]["fused_skip"],
                    f"overlapped fused-pf: routed {routed}, resolved mid-run "
                    f"{rows[fam]['fused_skip']}: it must resolve mid-run and finish direct")
        del out, fut
    emit({"phase": "cold_obs", "leg": "overlapped", "runs": rows,
          "fused_pf_load_s": fused_load_s, "device": smi})


def cold_telemetry(torch, np, kernels, smi, dev, g, sh, arrays, prog, s0):
    """Phase 19c: PageRank 10 iterations (mxscan) and SSSP from the largest
    out-degree, ring on and off: results and every kernel's launches
    equal, the ring's n the iterations, PageRank's residuals within
    TEL_RTOL of a float64 recomputation, SSSP's traversed and dense
    columns summing to the run's; ms an iteration each way (CUDA events,
    off, on, on, off)."""
    from lux_tpu_torch.engine import pull, push
    from lux_tpu_torch.graph.push_shards import build_push_shards
    from lux_tpu_torch.models.sssp import SSSPProgram
    from lux_tpu_torch.obs import ring

    tel = {}
    before = launch_snapshot(kernels)
    plain = pull.run_pull_fixed(prog, sh.spec, arrays, s0, ITERS, "mxscan")
    c_off = launch_delta(kernels, before)
    before = launch_snapshot(kernels)
    out, rg = pull.run_pull_fixed(prog, sh.spec, arrays, s0, ITERS, "mxscan",
                                  telemetry=ring.new_ring("pull_fixed", device=dev))
    c_on = launch_delta(kernels, before)
    rows_r, n_r = ring.ring_rows(rg)
    st, want = s0, []
    for _ in range(ITERS):
        nxt = pull.run_pull_fixed(prog, sh.spec, arrays, st, 1, "mxscan")
        want.append(float(np.abs(nxt.double().cpu().numpy() - st.double().cpu().numpy()).sum()))
        st = nxt
    resid_err = float(np.max(np.abs(rows_r[:, 1] - np.asarray(want))
                             / np.maximum(np.asarray(want), F32_TINY)))
    require(torch.equal(out, plain), "telemetry: PageRank with the ring differs")
    require(c_on == c_off, f"telemetry: PageRank launches {c_on} with the ring, {c_off} without")
    require(n_r == ITERS, f"telemetry: the PageRank ring holds {n_r} rows")
    require(resid_err <= TEL_RTOL, f"telemetry: residuals off float64 by {resid_err}")

    def pr_ms(on: bool) -> float:
        return time_ms(torch, lambda: pull.run_pull_fixed(
            prog, sh.spec, arrays, s0, ITERS, "mxscan",
            telemetry=ring.new_ring("pull_fixed", device=dev) if on else None), 5) / ITERS

    off1, on1, on2, off2 = pr_ms(False), pr_ms(True), pr_ms(True), pr_ms(False)
    tel["pagerank"] = {"iters": n_r, "residual": rows_r[:, 1].tolist(),
                       "max_rel_err_vs_f64": resid_err, "launches": c_on,
                       "ms_per_iter_off": [off1, off2], "ms_per_iter_on": [on1, on2]}
    del plain, out, rg, st, nxt
    start = int(np.argmax(g.out_degrees()))
    psh = build_push_shards(g, 1)
    sp = SSSPProgram(nv=g.nv, start=start)
    parr, pparr, carry0 = push.push_init(sp, psh, dev)

    def converge(on: bool):
        return push.run_push_chunk(sp, psh.pspec, psh.spec, parr, pparr, carry0, 10_000,
                                   "mxscan",
                                   telemetry=ring.new_ring("push", device=dev) if on else None)

    before = launch_snapshot(kernels)
    p_off = converge(False)
    c_off = launch_delta(kernels, before)
    before = launch_snapshot(kernels)
    p_on, prg = converge(True)
    c_on = launch_delta(kernels, before)
    prows, pn = ring.ring_rows(prg)
    require(torch.equal(p_on.state, p_off.state)
            and (p_on.it, p_on.edges) == (p_off.it, p_off.edges),
            "telemetry: SSSP with the ring differs")
    require(c_on == c_off, f"telemetry: SSSP launches {c_on} with the ring, {c_off} without")
    require(pn == p_on.it, f"telemetry: the push ring holds {pn} rows for {p_on.it} rounds")
    # each row's count is exact in f32 (a round walks at most ne = 2^24
    # edges); their sum is taken in int64
    ring_edges = int(prows[:, 2].astype(np.int64).sum())
    ring_dense = int(prows[:, 3].astype(np.int64).sum())
    require(ring_edges == p_on.edges and ring_dense == p_on.dense_rounds,
            f"telemetry: the push ring counts {ring_edges} edges and {ring_dense} dense "
            f"rounds, the run {p_on.edges} and {p_on.dense_rounds}")

    def ssp_ms(on: bool) -> float:
        return time_ms(torch, lambda: converge(on), 3) / p_off.it

    off1, on1, on2, off2 = ssp_ms(False), ssp_ms(True), ssp_ms(True), ssp_ms(False)
    tel["sssp"] = {"start": start, "iters": pn, "dense_rounds": p_on.dense_rounds,
                   "traversed": p_on.edges, "rows": prows.tolist(), "launches": c_on,
                   "ms_per_round_off": [off1, off2], "ms_per_round_on": [on1, on2]}
    emit({"phase": "cold_obs", "leg": "telemetry", **tel, "device": smi})


def cold_profile_dir(torch, kernels, smi, dev, g, pallas_counts, snap):
    """Phase 19d: `apps.pagerank --method pallas -ni 10 --profile-dir` in a
    subprocess (one profiler session a process) on the main graph's .lux
    snapshot ``snap`` (read, not generated again): its event log's one
    xprof.kernels point counts spmv's span kernel as often as the counters
    count an app run (phase 6, and the same work here), and its device
    total is within PROFILE_REL of the CUDA-event time of that work
    (apps.common.timed_iterations: ITERS iterations on a copy of the
    state, then ITERS on the state) timed here."""
    from lux_tpu_torch.models.pagerank import make_pallas_runner

    prof_dir = os.path.join(_TMP, "profile")
    cmd = [sys.executable, "-m", "lux_tpu_torch.apps.pagerank", "-file", snap,
           "--method", "pallas", "-ni", str(ITERS), "--profile-dir", prof_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    prof_wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"--profile-dir run failed: {proc.stderr[-2000:]}")
    points = [ev["a"] for ev in obs_events() if ev["e"] == "p" and ev["n"] == "xprof.kernels"]
    require(len(points) == 1, f"{len(points)} xprof.kernels points in the event log")
    pt = points[0]
    span_calls = sum(r["calls"] for r in pt["rows"] if "spmv_span_kernel" in r["name"])
    run_p, sp0 = make_pallas_runner(g, device=dev)

    def profiled_work():
        run_p(sp0.clone(), ITERS)
        run_p(sp0, ITERS)

    def device_ms() -> float:
        # the device's time for the work, not the host's: a sleeping
        # kernel queued first lets the host enqueue the whole window
        # before the start event runs, as the trace's kernels ran
        # back to back.  A host slowed by the oracle pool can take longer
        # than the sleep to enqueue the window (the gaps would then count
        # as the work's): the head start grows until it covers the enqueue
        cycles = SLEEP_CYCLES
        for _ in range(3):
            head = torch.cuda.Event(enable_timing=True)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            head.record()
            torch.cuda._sleep(cycles)
            start.record()
            t0 = time.perf_counter()
            profiled_work()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            end.record()
            torch.cuda.synchronize(dev)
            if enqueue_ms < head.elapsed_time(start):
                break
            cycles *= 8
        return start.elapsed_time(end)

    profiled_work()
    before = launch_snapshot(kernels)
    ev_ms = device_ms()
    work_counts = launch_delta(kernels, before)
    ev_ms2 = device_ms()
    emit({"phase": "cold_obs", "leg": "profile_dir", "argv": cmd[2:], "wall_seconds": prof_wall,
          "host_only": pt.get("host_only", False), "total_ms": pt["total_ms"],
          "calls": pt["calls"], "classes": pt["classes"],
          "top": [[r["name"][:120], r["class"], r["total_ms"], r["calls"]]
                  for r in pt["rows"][:10]],
          "spmv_span_calls": span_calls, "counter_app_run": pallas_counts["spmv_blockcsr"],
          "counter_here": work_counts["spmv_blockcsr"], "event_ms": [ev_ms, ev_ms2],
          "device": smi})
    require(not pt.get("host_only"), "the --profile-dir trace holds no device events")
    require(span_calls == pallas_counts["spmv_blockcsr"] == work_counts["spmv_blockcsr"],
            f"--profile-dir: spmv span kernel {span_calls} calls, the counters "
            f"{pallas_counts['spmv_blockcsr']} (phase 6) and {work_counts['spmv_blockcsr']}")
    require(abs(pt["total_ms"] - ev_ms) <= PROFILE_REL * ev_ms,
            f"--profile-dir: device total {pt['total_ms']:.4f} ms against the CUDA-event "
            f"{ev_ms:.4f} ms")


def cold_obs_main(torch, np, kernels, smi, dev, g, sh, plan_dir, main_pf, built_s,
                  pallas_counts, snap):
    """Phase 19: cold start and observability on the main graph, four legs
    (cold_app_runs, cold_overlapped, cold_telemetry, cold_profile_dir).
    Every launch counter is set to 0 at the start and read at the end:
    returns them."""
    from lux_tpu_torch.engine import pull
    from lux_tpu_torch.graph.shards import to_device
    from lux_tpu_torch.models.pagerank import PageRankProgram

    t_phase = time.perf_counter()
    for k in kernels.values():
        k.launches = 0
    load_s = cold_app_runs(np, kernels, smi, g, plan_dir, main_pf, built_s)
    torch.cuda.empty_cache()
    arrays = to_device(sh.arrays, dev)
    prog = PageRankProgram(nv=g.nv)
    s0 = pull.init_state(prog, arrays)
    cold_overlapped(torch, smi, dev, sh, arrays, prog, s0, plan_dir, load_s)
    torch.cuda.empty_cache()
    cold_telemetry(torch, np, kernels, smi, dev, g, sh, arrays, prog, s0)
    del arrays, s0
    torch.cuda.empty_cache()
    cold_profile_dir(torch, kernels, smi, dev, g, pallas_counts, snap)
    counts = launch_snapshot(kernels)
    for name in ("mxscan_segmented", "lane_gather", "fused_pass_gather", "spmv_blockcsr"):
        require(counts[name] > 0, f"cold_obs: {name} was never launched")
    emit({"phase": "cold_obs", "launches": counts, "seconds": time.perf_counter() - t_phase})
    return counts


def obs_log_main(smi):
    """The smoke's event log, read back: span totals by name over every
    process of the run; the OBS_SPANS must be there."""
    totals = {}
    events = obs_events()
    for name, _, t0, t1, _ in obs_spans(events):
        t = totals.setdefault(name, [0, 0.0])
        t[0] += 1
        t[1] += t1 - t0
    # the fleet controller's own heartbeat stalls (credited to its leases)
    stalls = [ev.get("a", {}).get("seconds", 0.0) for ev in events
              if ev["e"] == "p" and ev["n"] == "fleet.heartbeat_stall"]
    emit({"phase": "obs_log", "run_dir": obs_run_dir(),
          "files": len(glob.glob(os.path.join(obs_run_dir(), "events-*.jsonl"))),
          "span_totals": {k: {"count": v[0], "seconds": v[1]} for k, v in sorted(totals.items())},
          "heartbeat_stalls": {"count": len(stalls), "max_seconds": max(stalls, default=0.0)},
          "device": smi})
    missing = [n for n in OBS_SPANS if n not in totals]
    require(not missing, f"the event log lacks the spans {missing}")


#: the serving fleet and pods (phases 20-21)
FLEET_WORKERS = 2  # replica worker processes on the one card
FLEET_APPS = ("sssp", "ppr")
FLEET_BUCKETS = (1, 8, 64)
FLEET_VICTIM, FLEET_NTH = "w1", 5  # fault/drills.worker_kill_mid_burst's victim and query
FLEET_RTOL = 1e-5  # PPR through the fleet against the in-process engine
#: measure_fleet_saturation's ramp under scatter (auto's (E, Q) batch takes
#: ~2.6 s at Q = 64): one worker (the knee the autopilot phase is fed; two
#: against one is tools/fleet_bench.py's paired probe), levels of
#: FLEET_WINDOW_S seconds
FLEET_WIDTHS, FLEET_START_QPS, FLEET_LEVELS, FLEET_WINDOW_S = (1,), 48.0, 6, 0.5
POD_PARTS, POD_WORKERS = 8, 2  # one 8-part graph over two pod processes, 4 parts each


def close_enough(np, got, want, rtol: float) -> float:
    """The largest relative difference of two float arrays (zeros must be
    zeros), or inf when an element is off by more than ``rtol``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    if bool((diff > rtol * np.abs(want) + F32_TINY).any()):
        return float("inf")
    return float((diff / np.maximum(np.abs(want), F32_TINY)).max())


def fleet_answers(np, ctl, sources, apps, want_sssp, want_ppr, label: str) -> dict:
    """Submit every source of ``sources`` for each app of ``apps`` at once
    (one burst through the controller), wait for every answer and hold
    SSSP bitwise and PPR within FLEET_RTOL of the in-process answers.
    Returns per app the workers that answered, the seconds and the PPR
    error (and whether it was bitwise)."""
    t0 = time.perf_counter()
    futs = {app: [ctl.submit(int(s), app=app) for s in sources] for app in apps}
    out = {}
    for app, fs in futs.items():
        by = {}
        err, bitwise = 0.0, True
        for i, f in enumerate(fs):
            got = f.result(timeout=600)
            by[f.worker_id] = by.get(f.worker_id, 0) + 1
            want = (want_sssp if app == "sssp" else want_ppr)[i]
            require(got.shape == want.shape and bool(np.isfinite(got).all()),
                    f"{label}: {app} answer {i} is misshaped or not finite")
            if app == "sssp":
                require(np.array_equal(got, want),
                        f"{label}: sssp answer {i} (source {sources[i]}) differs from the "
                        "in-process engine")
            else:
                bitwise = bitwise and bool(np.array_equal(got, want))
                e = close_enough(np, got, want, FLEET_RTOL)
                require(e <= FLEET_RTOL, f"{label}: ppr answer {i} (seed {sources[i]}) off "
                                         f"the in-process engine beyond rtol {FLEET_RTOL}")
                err = max(err, e)
        out[app] = {"answered_by": by, "seconds": time.perf_counter() - t0}
        if app == "ppr":
            out[app].update(max_rel_err=err, bitwise=bitwise)
    return out


def fleet_worker_rows(ctl) -> dict:
    """Each live worker's last heartbeat: peak device bytes, completed,
    shed and its process's kernel launches."""
    rows = {}
    for wid, w in ctl.workers().items():
        hb = w["last_hb"]
        rows[wid] = {"alive": w["alive"], "peak_bytes": hb.get("peak_bytes"),
                     "completed": hb.get("completed"), "shed": hb.get("shed_total"),
                     "launches": hb.get("launches", {})}
    return rows


def fleet_diagnosis(torch, fleet, label: str) -> None:
    """On a failed fleet run, before its teardown deletes the workers'
    private tmpdirs: each worker's liveness and last heartbeat as the
    controller saw them, its process's exit code and the tail of its
    stderr, and the card's free memory, on standard error."""
    ctl = fleet.controller
    free, total = torch.cuda.mem_get_info()
    diag = {"fleet_failure": label, "controller": ctl.stats(),
            "workers": {w: {"alive": r["alive"], "last_hb": r["last_hb"]}
                        for w, r in ctl.workers().items()},
            "free_bytes": free, "total_bytes": total, "procs": {}}
    for p in fleet.procs:
        tail = ""
        if p.tmpdir is not None:
            try:
                with open(os.path.join(p.tmpdir, "stderr.log")) as fh:
                    tail = fh.read()[-3000:]
            except OSError as e:
                tail = repr(e)
        diag["procs"][p.worker_id] = {"rc": p.proc.poll(), "stderr_tail": tail}
    print(json.dumps(diag, default=str), file=sys.stderr, flush=True)


def fleet_main(torch, np, kernels, smi, dev, snap, serve_out, churn_snap):
    """Phase 20: the serving fleet on the card, serving ``snap`` (the main
    graph as a .lux snapshot); FLEET_WORKERS replica workers are CUDA
    processes started through the launcher (serve/fleet/bench.start_fleet,
    kernels built once in this process first) with apps FLEET_APPS and
    buckets FLEET_BUCKETS, the controller here.  Under auto: the
    SERVE_APP_Q serving sources of phase 17 for both apps at once, SSSP bitwise and
    PPR within FLEET_RTOL of phase 17's in-process answers; then the
    compacted 1 %-churn snapshot of phase 18 published through
    mutate/compact.publish_to_fleet while a burst of them is in flight:
    nothing shed, every burst answer the old graph's or the new one's,
    and after the commit all of them bitwise a fresh single-process engine on
    the snapshot (its first SERVE_BFS also equal phase 18's oracle).
    Under scatter (SSSP only, for the smoke's clock) with
    fault/drills.worker_kill_mid_burst in the workers'
    LUX_FAULT_PLAN: FLEET_VICTIM SIGKILLs itself at its FLEET_NTH query
    frame, and every query of the sources' burst is answered by the
    survivor, bitwise phase 17's answers.  Last,
    serve/fleet/bench.measure_fleet_saturation at widths FLEET_WIDTHS
    under scatter: QPS and p99 at the knee.  Each worker's peak device
    bytes come from its stats heartbeat.  Returns the workers' kernel
    launches, summed, and the rows."""
    from lux_tpu_torch.fault import drills
    from lux_tpu_torch.graph.format import read_lux
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.mutate.compact import publish_to_fleet
    from lux_tpu_torch.serve.batched import BatchedEngine
    from lux_tpu_torch.serve.fleet.bench import measure_fleet_saturation, start_fleet

    t_phase = time.perf_counter()
    sources, want_sssp, want_ppr = serve_out
    gid = f"rmat{SCALE}"
    launches = {name: 0 for name in kernels}
    rows = {}

    def add_launches(workers: dict) -> None:
        for w in workers.values():
            for name, n in w["launches"].items():
                launches[name] += n

    # fleet A: auto, the bitwise check, then the republish under a burst
    t0 = time.perf_counter()
    fleet = start_fleet(FLEET_WORKERS, graph_path=snap, graph_id=gid, mode="proc",
                        buckets=FLEET_BUCKETS, device=dev.type, apps=FLEET_APPS,
                        method="auto", pin=False)
    try:
        ctl = fleet.controller
        start_s = time.perf_counter() - t0
        require(sorted(ctl.live_workers()) == [f"w{i}" for i in range(FLEET_WORKERS)],
                f"fleet: live workers {ctl.live_workers()}")
        require(all(p.ready["device"].startswith(dev.type) for p in fleet.procs),
                f"fleet: a worker is not on {dev.type}: {[p.ready for p in fleet.procs]}")
        answers = fleet_answers(np, ctl, sources, FLEET_APPS, want_sssp, want_ppr, "fleet auto")
        # the churned snapshot's own answers, from a fresh in-process engine
        t1 = time.perf_counter()
        g2 = read_lux(churn_snap, mmap=False)
        sh2 = build_pull_shards(g2, 1)
        eng = BatchedEngine(sh2, "sssp", len(sources), method="auto", device=dev)
        want_new = eng.run(sources).state
        fresh_s = time.perf_counter() - t1
        del eng, sh2, g2
        torch.cuda.empty_cache()
        burst = [ctl.submit(int(s)) for s in sources]
        t1 = time.perf_counter()
        rep = publish_to_fleet(ctl, churn_snap, graph_id="churn1pct")
        publish_s = time.perf_counter() - t1
        old_or_new = {"old": 0, "new": 0}
        for i, f in enumerate(burst):
            a = f.result(timeout=600)
            if np.array_equal(a, want_sssp[i]):
                old_or_new["old"] += 1
            else:
                require(np.array_equal(a, want_new[i]),
                        f"fleet: burst answer {i} during the republish is neither graph's")
                old_or_new["new"] += 1
        after = [ctl.submit(int(s)) for s in sources]
        for i, f in enumerate(after):
            require(np.array_equal(f.result(timeout=600), want_new[i]),
                    f"fleet: answer {i} after the commit differs from a fresh engine on the "
                    "published snapshot")
        time.sleep(2 * ctl.hb_interval_s + 0.1)  # a heartbeat after the last batch
        st = ctl.stats()
        workers = fleet_worker_rows(ctl)
        require(st["shed"] == 0 and st["errors"] == 0 and st["timeouts"] == 0,
                f"fleet: the republish shed or failed requests: {st}")
        require(rep["generations"] == {f"w{i}": 1 for i in range(FLEET_WORKERS)}
                and not rep["retired"], f"fleet: republish {rep}")
        add_launches(workers)
        rows["auto"] = {"start_s": start_s, "answers": answers, "publish": rep,
                        "publish_s": publish_s, "fresh_engine_s": fresh_s,
                        "burst_during_publish": old_or_new, "controller": st,
                        "workers": workers}
        emit({"phase": "fleet", "run": "auto", **rows["auto"], "device": smi})
    except BaseException:
        fleet_diagnosis(torch, fleet, "auto")
        raise
    finally:
        fleet.close()
    torch.cuda.empty_cache()

    # fleet B: scatter, the kill drill in the workers' fault plan
    plan = drills.worker_kill_mid_burst(FLEET_VICTIM, nth_query=FLEET_NTH)
    t0 = time.perf_counter()
    fleet = start_fleet(FLEET_WORKERS, graph_path=snap, graph_id=gid, mode="proc",
                        buckets=FLEET_BUCKETS, device=dev.type, apps=("sssp",),
                        method="scatter", pin=False,
                        env={"LUX_FAULT_PLAN": plan.to_json()})
    try:
        ctl = fleet.controller
        start_s = time.perf_counter() - t0
        answers = fleet_answers(np, ctl, sources, ("sssp",), want_sssp, None,
                                "fleet kill drill")
        victim = next(p for p in fleet.procs if p.worker_id == FLEET_VICTIM)
        victim.proc.wait(timeout=60)
        survivor = [f"w{i}" for i in range(FLEET_WORKERS) if f"w{i}" != FLEET_VICTIM]
        time.sleep(2 * ctl.hb_interval_s + 0.1)
        st = ctl.stats()
        workers = fleet_worker_rows(ctl)
        require(victim.proc.returncode == -9,
                f"fleet: the victim exited {victim.proc.returncode}, not by SIGKILL")
        require(st["worker_deaths"] == 1 and ctl.live_workers() == survivor,
                f"fleet: after the drill {st}, live {ctl.live_workers()}")
        for app, a in answers.items():
            require(set(a["answered_by"]) == set(survivor),
                    f"fleet: {app} answers came from {a['answered_by']}, not the survivor")
        add_launches({w: r for w, r in workers.items() if r["alive"]})
        rows["kill_drill"] = {"start_s": start_s, "plan": plan.to_dict(), "answers": answers,
                              "victim_rc": victim.proc.returncode, "controller": st,
                              "workers": workers}
        emit({"phase": "fleet", "run": "kill_drill", **rows["kill_drill"], "device": smi})
    except BaseException:
        fleet_diagnosis(torch, fleet, "kill_drill")
        raise
    finally:
        fleet.close()
    torch.cuda.empty_cache()

    # the saturation ramp, one worker, scatter
    t0 = time.perf_counter()
    sat = measure_fleet_saturation(
        scale=SCALE, ef=EF, workers=FLEET_WIDTHS, mode="proc", buckets=FLEET_BUCKETS,
        start_qps=FLEET_START_QPS, max_levels=FLEET_LEVELS, window_s=FLEET_WINDOW_S,
        graph_path=snap, paired=False, trace_probe=False, device=dev.type,
        method="scatter")
    for row in sat["rows"]:
        emit({"phase": "fleet", "run": "saturation", "metric": row["metric"],
              "knee_qps": row["value"], "p99_ms": row["p99_ms"], "p50_ms": row["p50_ms"],
              "offered_at_knee": row["offered_at_knee"], "workers": row["workers"],
              "method": row["method"], "peak_bytes": row["peak_bytes"],
              "levels": [{k: lv[k] for k in ("offered_qps", "goodput_qps", "p99_ms",
                                              "fail_frac", "sustained")}
                         for lv in row["levels"]],
              "controller": {k: row["controller"][k] for k in
                             ("submitted", "completed", "shed", "rerouted", "timeouts")},
              "device": smi})
        require(row["value"] > 0 and row["controller"]["completed"] > 0,
                f"fleet: no goodput at width {row['workers']}")
    rows["saturation"] = {r["workers"]: {"knee_qps": r["value"], "p99_ms": r["p99_ms"]}
                          for r in sat["rows"]}
    emit({"phase": "fleet", "knees": sat["knees"], "launches": launches,
          "saturation_seconds": time.perf_counter() - t0,
          "seconds": time.perf_counter() - t_phase})
    return launches, rows


def pod_main(torch, np, kernels, smi, dev, g, snap, start):
    """Phase 21: a pod on the card.  POD_WORKERS pod worker processes
    (serve/fleet/launcher.launch_pod_worker, --device cuda) hold ``g``
    cut into POD_PARTS parts, 4 each, streamed to them over the wire from
    its snapshot ``snap``; run_pull_pod runs PageRank (ITERS
    iterations), SSSP from ``start`` and components under auto (mxscan on
    the card), each bitwise the single-process 8-part
    run_pull_fixed/run_pull_until on the card.  The pod's ms an iteration
    (wire and assembly included) stands beside the single-process one,
    timed here after an untimed run.  Each member's step replies carry the
    kernel launches its process made in that run (counted from its
    pod_build): mxscan_segmented once a resident part an iteration, in
    both.  The members' scan runs at the per-part shapes of the 8-part
    layout, so the kernel is held against its plain version there too:
    on the part with the most edges, on the edge values that the step
    reduces from each app's final single-process state (scan_case).
    Returns the members' launches summed over the apps and the members,
    and the scan rows."""
    from concurrent.futures import ThreadPoolExecutor

    from lux_tpu_torch.engine import pull
    from lux_tpu_torch.graph.shards import build_pull_shards, to_device
    from lux_tpu_torch.models.components import MaxLabelProgram
    from lux_tpu_torch.models.pagerank import PageRankProgram
    from lux_tpu_torch.models.sssp import SSSPProgram
    from lux_tpu_torch.ops import scan
    from lux_tpu_torch.program.spec import active_changed
    from lux_tpu_torch.serve.fleet import launcher
    from lux_tpu_torch.serve.fleet.pod import run_pull_pod

    t_phase = time.perf_counter()
    sh8 = build_pull_shards(g, POD_PARTS)
    arr = to_device(sh8.arrays, dev)
    launcher.prebuild_kernels(dev.type)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(POD_WORKERS) as ex:
        procs = list(ex.map(lambda i: launcher.launch_pod_worker(f"p{i}", device=dev.type),
                            range(POD_WORKERS)))
    start_s = time.perf_counter() - t0
    total = {name: 0 for name in kernels}
    rows = []
    # the part with the most edges: the scan's largest per-part shape
    big = int(torch.argmax(arr.row_ptr[:, -1]))
    part = arr.part(big)
    try:
        ends = [("127.0.0.1", p.port) for p in procs]
        for app, prog in (("pagerank", PageRankProgram(nv=g.nv)),
                          ("sssp", SSSPProgram(nv=g.nv, start=start)),
                          ("components", MaxLabelProgram())):
            s0 = pull.init_state(prog, arr)

            def single(s0=s0, prog=prog, app=app):
                if app == "pagerank":
                    return pull.run_pull_fixed(prog, sh8.spec, arr, s0, ITERS), ITERS
                return pull.run_pull_until(prog, sh8.spec, arr, s0, 10_000, active_changed)

            fence = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
            single()  # untimed: first launches, allocator growth
            fence()
            t0 = time.perf_counter()
            want, iters = single()
            fence()
            single_ms = (time.perf_counter() - t0) * 1e3 / int(iters)
            # the step's reduce on one part, on the edge values of the
            # final state, against the plain scan
            src, dst = pull.pull_gather_part(part, want.reshape(-1), want[big],
                                             prog.needs_dst_state)
            vals = prog.edge_value(src, part.weights, dst).contiguous()
            rows.append(scan_case(torch, scan, f"pod part {big} of {POD_PARTS}, {app}",
                                  vals, part.head_flag, part.row_ptr[-1:], prog.reduce, REPS))
            want = want.cpu().numpy()
            t0 = time.perf_counter()
            res = run_pull_pod(ends, snap, POD_PARTS, app=app, start=start, method="auto",
                               num_iters=ITERS, shutdown=app == "components")
            wall_s = time.perf_counter() - t0
            require(res["iters"] == int(iters),
                    f"pod {app}: {res['iters']} iterations, single-process {int(iters)}")
            require(res["state"].dtype == want.dtype and np.array_equal(res["state"], want),
                    f"pod {app}: the state differs from the single-process 8-part run")
            methods = {w["method"] for w in res["workers"].values()}
            require(methods == {"mxscan" if dev.type == "cuda" else "scan"},
                    f"pod {app}: members resolved {methods}")
            for w, r in res["workers"].items():
                want_n = (r["hi"] - r["lo"]) * res["iters"]
                require(r["launches"].get("mxscan_segmented", 0) == want_n,
                        f"pod {app}: member {w} launched mxscan "
                        f"{r['launches'].get('mxscan_segmented')} times, not {want_n}")
                for name in kernels:
                    total[name] += r["launches"].get(name, 0)
            emit({"phase": "pod", "app": app, "iters": res["iters"], "bitwise": True,
                  "pod_ms_per_iter": res["loop_s"] * 1e3 / res["iters"],
                  "single_ms_per_iter": single_ms, "scan_vs_plain": rows[-1],
                  "phases": res["phases"], "workers": res["workers"], "wall_seconds": wall_s,
                  "device": smi})
    finally:
        for p in procs:
            p.terminate(timeout_s=30.0)
    emit({"phase": "pod", "launches": total, "start_seconds": start_s,
          "seconds": time.perf_counter() - t_phase})
    del arr, sh8, part
    torch.cuda.empty_cache()
    return total, rows



#: live serving and the autopilot (phases 22-23)
LIVE_WORKERS = 2  # live replica worker processes on the one card
LIVE_SEED = 0  # the window's churn: np.random.default_rng(LIVE_SEED), serve/live/bench.churn_batch
#: the mixed window: 8 batches of 2,048 deletes + 2,048 inserts (16 before
#: PR 20, whose smoke cut this depth to pay for phase 25's routed legs)
LIVE_BATCHES, LIVE_ROWS = 8, 4096
#: per-part insert capacity of the live workers (--delta-cap): 5 batches fit
#: (10,240), the 6th overflows (12,288) and escalates to a fleet compaction;
#: the 4 batches after it (7-10, 8,192 inserts) fit the new epoch
LIVE_CAP, LIVE_COMPACT_AT = 10240, 6
LIVE_DRILL = 2  # after the window: generation 9 (the victim dies before its ack), 10
LIVE_VICTIM = "w1"
LIVE_ROUTE = "fused-pf"  # --route-gather of the standing PageRank (the reference's default)
LIVE_BUCKETS = (1, 8)
LIVE_READERS, LIVE_RMW, LIVE_MIN_WINDOW_S = 2, 0.25, 10.0
LIVE_BURST = 16  # the kill drill's queries, all answered by the survivor
LIVE_PR_RTOL = 1e-4  # standing PageRank against the float64 fixpoint
#: the autopilot phase: measure_autoscale over CUDA worker processes
PILOT_WINDOW_S = 1.5  # seconds an offered level lasts
CHAOS_STEPS = 4  # chaos_soak's churn steps (the reference's 16: ~15 s of wire-fault delays)
PILOT_OVERLOAD, PILOT_LOW = 4, 20  # levels at 1.5x, then 0.5x of the knee (after one at 0.5x)
PILOT_COOLDOWN_S = 5.0


def live_sequence(g, n: int):
    """The live phase's write sequence, regenerated independently of the
    fleet: the churn batches serve/live/bench.churn_batch draws with
    default_rng(LIVE_SEED) against the current epoch's delta-log, and the
    compaction that a per-part insert count above LIVE_CAP escalates to
    (the controller's journal folds every batch up to the overflowing one
    into a new base).  Yields (generation, the delta-log after it)."""
    import numpy as np

    from lux_tpu_torch.mutate.deltalog import DeltaLog
    from lux_tpu_torch.serve.live.bench import churn_batch

    rng = np.random.default_rng(LIVE_SEED)
    log = DeltaLog(g)
    for gen in range(1, n + 1):
        src, dst, op = churn_batch(log, rng, LIVE_ROWS)
        log.apply(src, dst, op)
        if int(log.live_inserts()[0].size) > LIVE_CAP:
            log = DeltaLog(log.merged_graph())
        yield gen, log


def live_plan(tmp: str, plan_dir: str):
    """The fused-pf plan of the live phase's post-compaction base (the
    merged graph at LIVE_COMPACT_AT), built into the plan disk cache the
    live workers load (LUX_TORCH_PLAN_CACHE), so no worker builds it.
    Runs in a process of its own beside phase 4's plan chains, from the
    main graph saved under ``tmp``.  Returns the base's fingerprint and
    seconds."""
    import numpy as np

    from lux_tpu_torch.graph import csc
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.ops import expand

    t0 = time.perf_counter()
    for gen, log in live_sequence(load_saved_graph(np, csc, tmp, "main"), LIVE_COMPACT_AT):
        pass
    base = log.base
    expand.plan_fused_shards_cached(build_pull_shards(base, 1), "sum", cache_dir=plan_dir,
                                    pf=True)
    return {"sha": graph_sha(base), "ne": base.ne, "seconds": time.perf_counter() - t0,
            "process_cpu_seconds": time.process_time()}


def live_oracles(scale: int):
    """The live phase's host oracles, built independently of the fleet
    (live_sequence): for the merged graph at the window's end (generation
    LIVE_BATCHES) scipy's BFS from the largest out-degree, the max-label
    fixpoint and the float64 PageRank fixpoint (60 iterations), the same
    for the merged graph after the kill drill (LIVE_BATCHES + LIVE_DRILL);
    each graph's fingerprint, and the post-compaction
    base's with a live worker's memory estimate on it.  Runs in the
    spawned pool."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models.components import fixpoint_labels
    from lux_tpu_torch.models.pagerank import _host_iteration

    t0 = time.perf_counter()
    g = generate.rmat(scale, EF, seed=0)
    start = int(np.argmax(np.bincount(g.col_idx, minlength=g.nv)))
    out = {"start": start}
    for gen, log in live_sequence(g, LIVE_BATCHES + LIVE_DRILL):
        if gen == LIVE_COMPACT_AT:
            out["base_sha"] = graph_sha(log.base)
            out["estimate_bytes"] = live_estimate(log.base)
        if gen not in (LIVE_BATCHES, LIVE_BATCHES + LIVE_DRILL):
            continue
        merged = log.merged_graph()
        adj = csr_matrix((np.ones(merged.ne), (merged.col_idx, merged.dst_of_edges())),
                         shape=(g.nv, g.nv))
        d = shortest_path(adj, directed=True, unweighted=True, indices=[start])[0]
        deg = merged.out_degrees().astype(np.float64)
        pr = np.where(deg > 0, (1.0 / g.nv) / np.maximum(deg, 1.0), 1.0 / g.nv)
        for _ in range(60):
            pr = _host_iteration(merged, pr, deg)
        out[gen] = {"sha": graph_sha(merged), "ne": merged.ne,
                    "dist": np.where(np.isinf(d), g.nv, d).astype(np.int32),
                    "labels": fixpoint_labels(merged), "pr": pr}
    out["seconds"] = time.perf_counter() - t0
    return out


def live_worker_args(snap: str, jdir: str, start: int) -> list:
    """A live replica worker's arguments (serve/fleet/worker.py --live)."""
    return ["--graph", snap, "--graph-id", f"rmat{SCALE}", "--parts", "1", "--apps", "sssp",
            "--buckets", ",".join(str(b) for b in LIVE_BUCKETS), "--method", "auto",
            "--live", "--journal-dir", jdir, "--delta-cap", str(LIVE_CAP),
            "--standing", f"sssp:{start},components,pagerank", "--route-gather", LIVE_ROUTE]


def live_estimate(g) -> int:
    """A live worker's device-memory estimate (utils/preflight): the
    serving engines at the largest bucket (auto), the standing push
    layout and states, and the standing PageRank's pull arrays with the
    fused-pf plan's analytic bytes.  The worker holds the pull arrays
    twice (the serving cache's copy and the refresh's)."""
    from lux_tpu_torch.graph.push_shards import build_push_shards
    from lux_tpu_torch.utils import preflight

    ps = build_push_shards(g, 1)
    serve = preflight.estimate_batched(ps.spec, max(LIVE_BUCKETS), "mxscan").total_bytes
    push = preflight.estimate_push(ps.spec, ps.pspec).total_bytes
    pull = preflight.add_routed_bytes(
        preflight.estimate_pull(ps.spec),
        preflight.routed_plan_bytes_analytic(ps.spec, LIVE_ROUTE)).total_bytes
    return int(serve + push + pull)


def live_kernel_cases(torch, np, scan, shuffle, expand, dev, base, batches, states, plan_dir,
                      reps):
    """The live path's kernels on the live overlay's inputs: the epoch
    base ``base`` with the epoch's ``batches`` in a MutableGraph at one
    part.  mxscan_segmented at the standing push round's shape (the
    dense round's per-edge candidates of the standing SSSP distances
    plus one and of the standing labels, tombstones masked to the
    reduce's identity): int32 min and max bitwise the plain version, and
    timed; fused_pass_gather (and the fill-forward's lane_gather) on the
    fused-pf route of the standing PageRank: the whole tombstoned
    apply_fused replay of the standing ranks bitwise its run with the
    kernels swapped for their plain versions, and timed.  Returns
    {kernel: max_abs_err} and the timing rows."""
    from lux_tpu_torch.mutate import overlay as ovl
    from lux_tpu_torch.mutate.graph import MutableGraph

    mg = MutableGraph(base, 1, cap=LIVE_CAP)
    for _, arr in batches:
        s, d, o = arr[:, 0], arr[:, 1], arr[:, 2].astype(np.int8)
        mg.log.apply(s, d, o)
    sh = mg.pull_shards
    _, oarr = mg.pull_overlay()
    del_val = torch.from_numpy(oarr.del_val[0]).to(dev)
    src_pos = torch.from_numpy(sh.arrays.src_pos[0]).to(dev).long()
    row_ptr = torch.from_numpy(sh.arrays.row_ptr[0]).to(dev)
    head = torch.from_numpy(sh.arrays.head_flag[0]).to(dev)
    m = int(row_ptr[-1])
    n = sh.spec.gathered_size

    def full(state):
        flat = np.zeros(n, np.int32)
        st = sh.global_to_stacked(np.asarray(state)).reshape(-1)
        flat[: st.size] = st
        return torch.from_numpy(flat).to(dev)

    rows, err = {}, {}
    inf = np.int32(base.nv)
    for op, state, label in (("min", states["sssp"], "sssp dist + 1"),
                             ("max", states["components"], "labels")):
        vals = full(state).index_select(0, src_pos)
        if op == "min":
            vals = torch.where(vals >= inf, vals, vals + 1)
        vals = ovl.mask_deleted(vals.contiguous(), del_val, op)
        got = scan.mxscan_segmented(vals, head, op=op, valid_end=row_ptr[-1:])
        want = scan.mxscan_segmented_plain(vals, head, op=op, valid_end=row_ptr[-1:])
        torch.cuda.synchronize()
        compare(torch, got[:m], want[:m], exact=True, what=f"live: mxscan int32 {op} ({label})")
        rows[f"mxscan_{op}"] = {
            "values": label, "n": int(vals.numel()),
            "tombstoned": int(del_val.sum()),
            "kernel_ms": time_ms(torch, lambda: scan.mxscan_segmented(
                vals, head, op=op, valid_end=row_ptr[-1:]), reps),
            "plain_ms": time_ms(torch, lambda: scan.mxscan_segmented_plain(
                vals, head, op=op, valid_end=row_ptr[-1:]), max(2, reps // 4)),
            "bound_ms": bound_ms(vals.numel() * 9)}
    err["mxscan_segmented"] = 0.0
    # the standing PageRank's route: the fused-pf plan of the epoch base
    plan = expand.plan_fused_shards_cached(sh, "sum", cache_dir=plan_dir, pf=True)
    st, arrs = expand.plan_to_device(plan, dev)
    p0 = tuple(a[0] for a in arrs)
    pr = np.zeros(n, np.float32)
    stp = sh.global_to_stacked(np.asarray(states["pagerank"], np.float32)).reshape(-1)
    pr[: stp.size] = stp
    x = torch.from_numpy(pr).to(dev)
    names = ("lane_gather", "fused_pass_gather")
    real = {k: getattr(shuffle, k) for k in names}

    def replay():
        out = expand.apply_fused(x, st, p0, del_val=del_val)
        torch.cuda.synchronize()
        return out

    got = replay()
    kernel_ms = time_ms(torch, replay, reps)
    try:
        for k in names:
            setattr(shuffle, k, getattr(shuffle, f"{k}_plain"))
        want = replay()
        plain_ms = time_ms(torch, replay, max(2, reps // 4))
    finally:
        for k, fn in real.items():
            setattr(shuffle, k, fn)
    require(torch.equal(got, want),
            "live: the tombstoned fused-pf replay of the standing ranks differs with the "
            "plain kernels")
    err["fused_pass_gather"] = err["lane_gather"] = 0.0
    rows["fused_pf_replay"] = {"n2": int(st.n2), "tombstoned": int(del_val.sum()),
                               "kernel_ms": kernel_ms, "plain_ms": plain_ms}
    return err, rows


def live_main(torch, np, kernels, smi, dev, g, snap, start, plan_dir, live_oracle,
              sources, reps):
    """Phase 22: live (mutation-aware) serving on the card.  LIVE_WORKERS
    live replica worker processes (serve/fleet/worker.py --live, each a
    CUDA process with a journal directory, --delta-cap LIVE_CAP, standing
    SSSP from ``start``, components and PageRank on the LIVE_ROUTE route,
    phase 4's plan cache as LUX_TORCH_PLAN_CACHE) serve ``snap`` behind a
    LiveFleetController (its journal and compaction snapshot here).

    The mixed window (serve/live/bench.mixed_window): a writer admits
    LIVE_BATCHES churn batches of LIVE_ROWS rows while LIVE_READERS
    closed-loop readers send SSSP queries over the 16 serving sources, a
    quarter of them bounded by the last acknowledged generation; batch
    LIVE_COMPACT_AT overflows the workers' capacity and escalates to a
    fleet compaction.  Then one refresh_fleet (the standing states' first
    convergence).  Gates: 0 shed, 0 deaths, 0 read errors, every bounded
    read tagged at or above its bound, one compaction at
    LIVE_COMPACT_AT; the controller's merged graph the pool's
    independently regenerated one; answers after the compaction bitwise
    a fresh engine on the merged graph; each replica's standing SSSP and
    components bitwise the pool's scipy BFS and max-label fixpoint and
    each other, standing PageRank within LIVE_PR_RTOL of the float64
    fixpoint and bitwise across the replicas.  The live kernels against
    their plain versions (live_kernel_cases).  Then the kill drill:
    LIVE_VICTIM's fault plan SIGKILLs it at worker.before_delta_ack of
    generation LIVE_BATCHES + 1, the survivor acknowledges that batch and
    the next and answers a LIVE_BURST-query burst, refreshes warm; the
    victim is relaunched from the compaction snapshot and its own journal
    (generation LIVE_BATCHES + 1) and caught up by the controller's
    stream (the last batch); after a refresh its standing SSSP and
    components are bitwise the survivor's and the pool's oracles, its
    PageRank bitwise the survivor's, and that within LIVE_PR_RTOL of the
    float64 fixpoint of the merged graph after the drill.  Returns the
    workers' kernel launches, summed."""
    from concurrent.futures import ThreadPoolExecutor

    from lux_tpu_torch import obs
    from lux_tpu_torch.fault.plan import FaultPlan, FaultRule
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.ops import expand, scan, shuffle
    from lux_tpu_torch.serve.batched import BatchedEngine
    from lux_tpu_torch.serve.fleet import launcher
    from lux_tpu_torch.serve.live.bench import churn_batch, mixed_window
    from lux_tpu_torch.serve.live.controller import LiveFleetController

    t_phase, t_mono = time.perf_counter(), time.monotonic()
    tmp = os.path.join(_TMP, "live")
    os.makedirs(tmp, exist_ok=True)
    ctl = LiveFleetController(g, journal_dir=os.path.join(tmp, "controller"),
                              snapshot_path=os.path.join(tmp, "snap.lux"),
                              refresh_timeout_s=900.0)
    jdirs = {f"w{i}": os.path.join(tmp, f"w{i}") for i in range(LIVE_WORKERS)}
    # the victim dies at its first ack after the window: the window's
    # overflowing batch answers before the point, so it fires once for
    # each of the others
    after = LIVE_BATCHES - 1
    plan = FaultPlan([FaultRule("proc", "kill", point="worker.before_delta_ack", after=after,
                                count=1, callback=f"kill:{LIVE_VICTIM}",
                                note="drill: SIGKILL between a durable delta and its ack")],
                     name="live_kill_before_ack")
    base_env = {"LUX_OBS_RUN_ID": obs.run_id(), "LUX_TORCH_PLAN_CACHE": plan_dir}

    def launch(wid: str, graph: str, env: dict):
        return launcher.launch_fleet_worker(wid, live_worker_args(graph, jdirs[wid], start),
                                            device=dev.type, env={**base_env, **env},
                                            ready_timeout_s=600.0)

    procs = {}
    out = {"device": smi}
    worker_launches = {}
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(LIVE_WORKERS) as ex:
            futs = {wid: ex.submit(launch, wid, snap,
                                   {"LUX_FAULT_PLAN": plan.to_json()} if wid == LIVE_VICTIM
                                   else {})
                    for wid in jdirs}
            for wid, f in futs.items():
                procs[wid] = f.result()
        for wid in jdirs:
            ctl.add_worker("127.0.0.1", procs[wid].port)
        out["start_s"] = time.perf_counter() - t0
        require(ctl.live_workers() == sorted(jdirs), f"live: workers {ctl.live_workers()}")
        require(all(p.ready["device"].startswith(dev.type) and p.ready["delta_generation"] == 0
                    for p in procs.values()), f"live: {[p.ready for p in procs.values()]}")

        # the mixed window
        rng = np.random.default_rng(LIVE_SEED)
        win = mixed_window(ctl, sources, rng, batch_rows=LIVE_ROWS,
                           write_batches=LIVE_BATCHES, reader_threads=LIVE_READERS,
                           rmw_frac=LIVE_RMW, min_window_s=LIVE_MIN_WINDOW_S,
                           read_timeout_s=600.0)
        st = ctl.stats()
        compact_s = win["write_s_each"][LIVE_COMPACT_AT - 1]
        window = {k: win[k] for k in (
            "write_batches_per_s", "write_rows_per_s", "read_qps", "reads", "read_errors",
            "bounded_reads", "bounded_below_bound", "read_p50_ms", "read_p99_ms",
            "staleness_gen_p50", "staleness_gen_p99", "write_seconds", "window_seconds",
            "compactions")}
        window.update(compaction_admit_s=compact_s, admit_s=win["write_s_each"],
                      shed=st["shed"], deaths=st["worker_deaths"], errors=st["errors"],
                      timeouts=st["timeouts"], resyncs=st["resyncs"])
        emit({"phase": "live", "run": "window", **window, "device": smi})
        require(st["shed"] == 0 and st["worker_deaths"] == 0 and win["read_errors"] == 0,
                f"live: the window shed, lost a worker or failed reads: {window}")
        require(win["bounded_reads"] > 0 and win["bounded_below_bound"] == 0,
                f"live: bounded reads below their bound: {window}")
        require(win["compactions"] == 1 and ctl.journal.base_generation == LIVE_COMPACT_AT
                and ctl.generation() == LIVE_BATCHES,
                f"live: compactions {win['compactions']}, base "
                f"{ctl.journal.base_generation}, generation {ctl.generation()}")
        require(ctl.worker_generations() == {w: LIVE_BATCHES for w in jdirs},
                f"live: replicated generations {ctl.worker_generations()}")
        require(sum(LIVE_VICTIM in a for a in win["acks"]) == after + 1,
                f"live: the victim acked {sum(LIVE_VICTIM in a for a in win['acks'])} batches")
        o = live_oracle.result(timeout=1200)
        merged = ctl.journal.log.merged_graph()
        require(o["base_sha"] == graph_sha(ctl.journal.log.base)
                and o[LIVE_BATCHES]["sha"] == graph_sha(merged),
                "live: the controller's merged graph is not the pool's regenerated one")
        # the answers after the compaction: a fresh engine on the merged graph
        t0 = time.perf_counter()
        eng = BatchedEngine(build_pull_shards(merged, 1), "sssp", max(LIVE_BUCKETS),
                            method="auto", device=dev)
        probe = [int(s) for s in sources[: max(LIVE_BUCKETS)]]
        want = eng.run(probe).state
        del eng
        torch.cuda.empty_cache()
        futs = [ctl.submit(s, min_generation=LIVE_BATCHES) for s in probe]
        for i, f in enumerate(futs):
            require(np.array_equal(f.result(timeout=600), want[i]),
                    f"live: answer {i} after the compaction differs from a fresh engine")
        out["fresh_engine_s"] = time.perf_counter() - t0

        # the standing states' first convergence, on every replica
        r1 = ctl.refresh_fleet(timeout_s=900.0)
        emit({"phase": "live", "run": "refresh", "kind": "first", **r1, "device": smi})
        states = {}
        for app in ("sssp", "components", "pagerank"):
            allr = ctl.read_standing_all(app)
            require(set(allr) == set(jdirs)
                    and all(e["generation"] == LIVE_BATCHES for e in allr.values()),
                    f"live: standing {app} tags {[(w, e['generation']) for w, e in allr.items()]}")
            a, b = (allr[w]["state"] for w in sorted(jdirs))
            require(np.array_equal(a, b), f"live: standing {app} differs across the replicas")
            if app == "sssp":
                require(np.array_equal(a, o[LIVE_BATCHES]["dist"]),
                        "live: standing SSSP differs from scipy's BFS of the merged graph")
            elif app == "components":
                require(np.array_equal(a, o[LIVE_BATCHES]["labels"]),
                        "live: standing labels differ from the max-label fixpoint")
            else:
                out["pagerank_rel_err"] = rel_err(np, a, o[LIVE_BATCHES]["pr"])
                require(out["pagerank_rel_err"] <= LIVE_PR_RTOL,
                        f"live: standing PageRank off the f64 fixpoint by "
                        f"{out['pagerank_rel_err']}")
            states[app] = a
        out["refresh_first"] = r1

        # the live path's kernels against their plain versions
        t0 = time.perf_counter()
        kerr, krows = live_kernel_cases(torch, np, scan, shuffle, expand, dev,
                                        ctl.journal.log.base,
                                        ctl.journal.batches_since(LIVE_COMPACT_AT), states,
                                        plan_dir, reps)
        emit({"phase": "live", "run": "kernels", **krows, "seconds": time.perf_counter() - t0,
              "device": smi})
        torch.cuda.empty_cache()

        # the kill drill: the victim dies between a durable delta and its ack
        t0 = time.perf_counter()
        victim_hb = None
        reps_drill = []
        for i in range(LIVE_DRILL):
            src, dst, op = churn_batch(ctl.journal.log, rng, LIVE_ROWS)
            reps_drill.append(ctl.admit_writes(src, dst, op))
            if i == 0:
                procs[LIVE_VICTIM].proc.wait(timeout=120)
                victim_hb = ctl.workers()[LIVE_VICTIM]["last_hb"]
        survivor = [w for w in sorted(jdirs) if w != LIVE_VICTIM]
        last = LIVE_BATCHES + LIVE_DRILL
        require(procs[LIVE_VICTIM].proc.returncode == -9,
                f"live: the victim exited {procs[LIVE_VICTIM].proc.returncode}, not by SIGKILL")
        require([r["acked"] for r in reps_drill] == [survivor] * LIVE_DRILL
                and reps_drill[-1]["generation"] == last,
                f"live: drill admits {reps_drill}")
        require(ctl.live_workers() == survivor, f"live: live workers {ctl.live_workers()}")
        burst = [start] + [int(s) for s in sources[: LIVE_BURST - 1]]
        futs = [ctl.submit(s, min_generation=last) for s in burst]
        answered = [f.result(timeout=600) for f in futs]
        require(all(f.worker_id == survivor[0] for f in futs),
                "live: a drill query was not answered by the survivor")
        require(np.array_equal(answered[0], o[last]["dist"]),
                "live: the survivor's answer from the standing start differs from scipy's BFS")
        drill_s = time.perf_counter() - t0
        r2 = ctl.refresh_fleet(timeout_s=900.0)
        emit({"phase": "live", "run": "refresh", "kind": "warm (survivor)", **r2,
              "device": smi})
        # the victim relaunched from the compaction snapshot and its own
        # journal; its dead handle is reaped first (kill() removes its
        # private lux-launch-* directory)
        t0 = time.perf_counter()
        procs[LIVE_VICTIM].kill()
        h = launch(LIVE_VICTIM, ctl.snapshot_path, {})
        procs[LIVE_VICTIM] = h
        replayed = h.ready["delta_generation"]
        ctl.add_worker("127.0.0.1", h.port)
        catchup_s = time.perf_counter() - t0
        require(replayed == LIVE_BATCHES + 1,
                f"live: the relaunched victim replayed to generation {replayed}")
        require(ctl.worker_generations() == {w: last for w in jdirs},
                f"live: after the catch-up {ctl.worker_generations()}")
        r3 = ctl.refresh_fleet(timeout_s=900.0)
        emit({"phase": "live", "run": "refresh", "kind": "relaunched (cold) + survivor", **r3,
              "device": smi})
        ulps = None
        for app in ("sssp", "components", "pagerank"):
            allr = ctl.read_standing_all(app)
            a, b = allr[survivor[0]]["state"], allr[LIVE_VICTIM]["state"]
            require(all(e["generation"] == last for e in allr.values()),
                    f"live: standing {app} tags after the drill")
            if app == "pagerank":
                ulps = ulp_diff(np, a, b)
                out["pagerank_rel_err_drill"] = rel_err(np, a, o[last]["pr"])
                require(np.array_equal(a, b),
                        f"live: the relaunched replica's PageRank is {ulps} ulps off the "
                        f"survivor's, not bitwise")
                require(out["pagerank_rel_err_drill"] <= LIVE_PR_RTOL,
                        f"live: standing PageRank after the drill off the f64 fixpoint by "
                        f"{out['pagerank_rel_err_drill']}")
            else:
                require(np.array_equal(a, b),
                        f"live: the relaunched replica's {app} differs from the survivor's")
                require(np.array_equal(a, o[last]["dist" if app == "sssp" else "labels"]),
                        f"live: standing {app} after the drill differs from the oracle")
        time.sleep(2 * ctl.hb_interval_s + 0.1)  # a heartbeat after the last work
        st = ctl.stats()
        rows = fleet_worker_rows(ctl)
        require(st["worker_deaths"] == 1 and st["shed"] == 0,
                f"live: after the drill {st}")
        events = obs_events()
        stalls = [ev.get("a", {}).get("seconds", 0.0) for ev in events
                  if ev["e"] == "p" and ev["n"] == "fleet.heartbeat_stall"
                  and ev["t"] >= t_mono]
        worker_launches = {w: r["launches"] for w, r in rows.items()}
        worker_launches[f"{LIVE_VICTIM} (killed)"] = (victim_hb or {}).get("launches", {})
        compact_spans = obs_spans(events, "live.compact_fleet", since=t_mono)
        out.update(drill_s=drill_s, catchup_s=catchup_s, replayed_to=replayed,
                   pagerank_ulps_relaunched=ulps, controller=st,
                   compaction_span_s=[t1 - t0_ for _, _, t0_, t1, _ in compact_spans],
                   heartbeat_stalls={"count": len(stalls), "max_seconds": max(stalls, default=0.0)},
                   peak_bytes={w: r["peak_bytes"] for w, r in rows.items()},
                   killed_peak_bytes=(victim_hb or {}).get("peak_bytes"),
                   estimate_bytes=o["estimate_bytes"], launches=worker_launches,
                   refresh_seconds={"first": {w: r["apps"] for w, r in r1["workers"].items()},
                                    "warm": {w: r["apps"] for w, r in r2["workers"].items()},
                                    "after_relaunch": {w: r["apps"]
                                                       for w, r in r3["workers"].items()}})
    except BaseException:
        from lux_tpu_torch.serve.fleet.bench import Fleet

        fleet_diagnosis(torch, Fleet(ctl, [], list(procs.values())), "live")
        raise
    finally:
        ctl.close(shutdown_workers=True)
        for p in procs.values():
            p.terminate(timeout_s=30.0)
    left = launch_dirs()
    require(not left, f"live: launcher directories left behind: {left}")
    total = {name: sum(c.get(name, 0) for c in worker_launches.values()) for name in kernels}
    require(dev.type != "cuda" or (total["mxscan_segmented"] > 0
                                   and total["fused_pass_gather"] > 0),
            f"live: the workers did not launch the path's kernels: {total}")
    emit({"phase": "live", **out, "launches_total": total,
          "seconds": time.perf_counter() - t_phase})
    return total, kerr


def autopilot_main(torch, np, kernels, smi, dev, snap, knee):
    """Phase 23: the autopilot on the card.  serve/fleet/bench
    .measure_autoscale on ``snap`` under scatter, one CUDA worker process
    to start, launcher.process_spawner CUDA worker processes for the
    autoscaler (min 1, max 2), fed phase 20's one-worker knee ``knee``:
    one level at 0.5x the knee (the scaler holds), up to
    PILOT_OVERLOAD at 1.5x (it must scale up), then up to PILOT_LOW at
    0.5x (it must scale down, the same worker — LIFO — at least
    PILOT_COOLDOWN_S later); no query lost (no error, no timeout), the
    shed fraction inside the policy's budget.  The scaler is told the
    offered load of each level (as in the reference's bench), so these
    gates check its arithmetic against the knee and the fleet's join and
    retire of a CUDA worker process, not that the card's own signals
    detect the overload; each level's goodput, p99 and ``sustained`` are
    what the card measured, and are printed.  Then, with the replicas as
    CUDA thread workers here, fault/chaos.autopilot_soak(seed=0) at the
    reference's sizes and chaos_soak(seed=0) at CHAOS_STEPS steps (a
    quarter of the reference's 16, for the smoke's clock), and election_drill on
    the unfenced election counterexample that the model checker finds
    (analysis/proto): the unfenced group reproduces the split brain (2
    elections), the fenced group absorbs the same schedule (1).
    Returns the kernel launches of the soaks (this process)."""
    from lux_tpu_torch import obs
    from lux_tpu_torch.analysis.proto.election_model import ElectionModel
    from lux_tpu_torch.analysis.proto.export import export_faultplan
    from lux_tpu_torch.analysis.proto.mc import check
    from lux_tpu_torch.fault.chaos import autopilot_soak, chaos_soak, election_drill
    from lux_tpu_torch.fault.plan import FaultPlan
    from lux_tpu_torch.serve.fleet import launcher
    from lux_tpu_torch.serve.fleet.bench import measure_autoscale

    t_phase = time.perf_counter()
    gid = f"rmat{SCALE}"
    spawner = launcher.process_spawner(
        prefix="as", device=dev.type, env={"LUX_OBS_RUN_ID": obs.run_id()},
        extra_args=["--graph", snap, "--graph-id", gid, "--parts", "1", "--apps", "sssp",
                    "--buckets", ",".join(str(b) for b in FLEET_BUCKETS),
                    "--method", "scatter"])
    t0 = time.perf_counter()
    res = measure_autoscale(
        knee, spawner, scale=SCALE, ef=EF, buckets=FLEET_BUCKETS, window_s=PILOT_WINDOW_S,
        overload_levels=PILOT_OVERLOAD, low_levels=PILOT_LOW, cooldown_s=PILOT_COOLDOWN_S,
        mode="proc", graph_path=snap, device=dev.type, method="scatter")
    (row,) = res["rows"]
    levels = res["levels"]
    acts = [(i, lv["scale_action"]) for i, lv in enumerate(levels) if "scale_action" in lv]
    lost = sum(lv["errors"] + lv["timeouts"] for lv in levels)
    emit({"phase": "autopilot", "run": "autoscale", "knee_qps": knee,
          "levels": [{k: lv.get(k) for k in ("phase", "offered_qps", "submitted", "completed",
                                               "shed", "timeouts", "errors", "goodput_qps",
                                               "p50_ms", "p99_ms", "sustained", "alive")}
                     for lv in levels],
          "actions": [{**a, "level": i} for i, a in acts], "lost": lost,
          "shed_frac": row["shed_frac"], "max_shed_frac": row["max_shed_frac"],
          "pilot": row["pilot"], "seconds": time.perf_counter() - t0, "device": smi})
    require([a["action"] for _, a in acts] == ["scale_up", "scale_down"],
            f"autopilot: scale actions {[a for _, a in acts]}")
    (iu, up), (idn, down) = acts
    require(up["worker"] == down["worker"], "autopilot: the scale-down was not LIFO")
    require(levels[iu]["phase"] == "overload" and levels[idn]["phase"] == "low",
            "autopilot: scaled at the wrong load")
    require(levels[idn]["t"] - levels[iu]["t"] >= PILOT_COOLDOWN_S,
            "autopilot: scaled down inside the cooldown")
    require(lost == 0 and row["shed_bounded"], f"autopilot: lost {lost}, row {row['shed_frac']}")
    # the soaks, with CUDA thread workers
    for fn in kernels.values():
        fn.launches = 0
    soaks = {}
    for name, fn, kw in (("autopilot_soak", autopilot_soak, {}),
                         ("chaos_soak", chaos_soak, {"steps": CHAOS_STEPS})):
        t0 = time.perf_counter()
        rep = fn(0, device=dev, **kw)
        soaks[name] = {k: v for k, v in rep.items() if k not in ("events", "fault_counters")}
        soaks[name]["seconds"] = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in kernels.items()}
    require(soaks["autopilot_soak"]["scale_ups"] >= 1
            and soaks["autopilot_soak"]["elections"] == 1
            and soaks["autopilot_soak"]["compactions"] >= 1, f"autopilot: {soaks}")
    emit({"phase": "autopilot", "run": "soaks", **soaks, "launches": counts, "device": smi})
    # the model checker's counterexample replayed on the real election
    t0 = time.perf_counter()
    cex = check(ElectionModel(n_standbys=2, fenced=False, max_restarts=1))
    clean = check(ElectionModel(n_standbys=3, fenced=True, max_restarts=1))
    require(cex.violation is not None and clean.ok, "autopilot: the election model")
    plan_json = export_faultplan(cex).to_json()
    unf = election_drill(FaultPlan.from_json(plan_json), fenced=False)
    fen = election_drill(FaultPlan.from_json(plan_json), fenced=True)
    emit({"phase": "autopilot", "run": "election_drill", "trace": list(cex.violation.trace),
          "clean_states": clean.states, "unfenced": unf, "fenced": fen,
          "seconds": time.perf_counter() - t0})
    require(unf["elections"] == 2 and fen["elections"] == 1,
            f"autopilot: election drill unfenced {unf}, fenced {fen}")
    emit({"phase": "autopilot", "seconds": time.perf_counter() - t_phase})
    return counts


#: big graphs from disk (phase 24)
DISK_PARTS = 8  # the file-loaded RMAT STREAM_SCALE graph's parts, stacked on the card
DISK_LAYOUTS = (("default", []), ("sorted", ["--sort-segments"]),
                ("compact", ["--compact-gather"]),
                ("both", ["--sort-segments", "--compact-gather"]))
DISK_PUSH = (("compact", ["--compact-gather"]), ("sorted", ["--sort-segments"]))
SORTED_SCALE = 18  # the --sort-segments --route-gather fused-pf PageRank (plan: phase 4)


def sorted_plan(tmp: str, plan_dir: str):
    """Phase 4's fifth process: the fused-pf plan of the --sort-segments
    one-part layout of RMAT SORTED_SCALE, built into the plan cache that
    phase 24 loads; the graph is handed to phase 24 under ``tmp``.
    Returns its seconds."""
    import numpy as np

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.ops import expand

    t0 = time.perf_counter()
    g = generate.rmat(SORTED_SCALE, EF, seed=0)
    save_graph(np, tmp, f"rmat{SORTED_SCALE}", g)
    expand.plan_fused_shards_cached(build_pull_shards(g, 1, sort_segments=True), "sum",
                                    cache_dir=plan_dir, pf=True)
    return {"scale": SORTED_SCALE, "seconds": time.perf_counter() - t0,
            "process_cpu_seconds": time.process_time()}


@contextlib.contextmanager
def held_kernels(torch, shuffle, names, calls: dict):
    """Inside the block every launch of the named routed kernels also
    runs its plain version on the same inputs (not a launch) and must
    agree bitwise; ``calls[name]`` counts the launches held."""
    orig = {n: getattr(shuffle, n) for n in names}

    def hold(name):
        plain = getattr(shuffle, f"{name}_plain")

        def fn(*a, **kw):
            got = orig[name](*a, **kw)
            require(torch.equal(got, plain(*a, **kw)),
                    f"disk_main: {name} differs from its plain version")
            calls[name] = calls.get(name, 0) + 1
            return got
        # the wrapper counts its launches by its module name, which is this
        # function's while held: the kernels' own counters stay untouched
        fn.launches = 0
        return fn

    for n in names:
        setattr(shuffle, n, hold(n))
    try:
        yield
    finally:
        for n, f in orig.items():
            setattr(shuffle, n, f)


def same_arrays(np, a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
               for x, y in zip(a, b))


def host_builds(np, native_io, g, path: str) -> dict:
    """Phase 24a: the host builds, native against NumPy, each timed once
    and bitwise equal: the RMAT STREAM_SCALE file through load_pull_shards
    at DISK_PARTS parts (preads and the native fill, against the memory
    map and numpy) and its per-part range reads alone (pread against a
    copy out of the memory map); on the main graph build_pull_shards and
    build_push_shards at DISK_PARTS parts and build_blockcsr."""
    from lux_tpu_torch.graph import format as fmt
    from lux_tpu_torch.graph import sharded_load
    from lux_tpu_torch.graph.push_shards import build_push_shards
    from lux_tpu_torch.graph.shards import build_pull_shards, shard_geometry
    from lux_tpu_torch.ops import spmv

    header = fmt.read_lux(path)
    degrees = sharded_load.out_degrees_from_file(path, header=header)
    cuts = shard_geometry(np.asarray(header.row_ptr), DISK_PARTS)[0]

    def read_all():
        n = 0
        for p in range(DISK_PARTS):
            rp, cols, _ = fmt.read_lux_range(path, int(cuts[p]), int(cuts[p + 1]),
                                             header=header)
            n += np.array(rp).nbytes + np.array(cols).nbytes
        return n

    out = {}
    for name, fn, flat in (
            ("read_ranges", read_all, None),
            ("load_pull_shards", lambda: sharded_load.load_pull_shards(
                path, DISK_PARTS, degrees=degrees), lambda r: r.arrays),
            ("pull_build", lambda: build_pull_shards(g, DISK_PARTS), lambda r: r.arrays),
            ("push_build", lambda: build_push_shards(g, DISK_PARTS),
             lambda r: tuple(r.arrays) + tuple(r.parrays)),
            ("blockcsr_build", lambda: spmv.build_blockcsr(g),
             lambda r: (r.e_src_pos, r.e_dst_rel, r.chunk_block, r.chunk_first))):
        t0 = time.perf_counter()
        nat = fn()
        nat_s = time.perf_counter() - t0
        with native_io.numpy_path():
            t0 = time.perf_counter()
            npy = fn()
            npy_s = time.perf_counter() - t0
        row = {"native_s": nat_s, "numpy_s": npy_s}
        if flat is None:
            require(nat == npy, f"disk_main {name}: {nat} bytes against {npy}")
            row["bytes"] = nat
        else:
            require((nat.host_io, npy.host_io) == ("native", "numpy"),
                    f"disk_main {name}: host paths {nat.host_io}, {npy.host_io}")
            require(same_arrays(np, flat(nat), flat(npy)),
                    f"disk_main {name}: the native arrays differ from numpy's")
        out[name] = row
        del nat, npy
    return out


def disk_main(torch, np, kernels, smi, dev, tmp, g, start, o_dist, o_labels, long_s,
              plan_dir, reps):
    """Phase 24: big graphs from disk (see the module docstring).  Returns
    (launches {run: counts}, kernel rows, {the .lux path, the default
    layout's ranks, the float64 oracle}: phase dist's inputs)."""
    from lux_tpu_torch.apps import components as cc_app
    from lux_tpu_torch.apps import pagerank as pr_app
    from lux_tpu_torch.apps import sssp as sssp_app
    from lux_tpu_torch.engine import pull
    from lux_tpu_torch.graph import csc
    from lux_tpu_torch.graph import format as fmt
    from lux_tpu_torch.graph import sharded_load
    from lux_tpu_torch.graph.shards import (ShardArrays, build_compact_mirror,
                                            build_pull_shards, sort_segments_inplace,
                                            to_device)
    from lux_tpu_torch.models import sssp as sssp_model
    from lux_tpu_torch.models.pagerank import PageRankProgram, pagerank_reference
    from lux_tpu_torch.native import io as native_io
    from lux_tpu_torch.ops import expand, scan, shuffle

    t_phase = time.perf_counter()
    require(native_io.host_path() == "native", "disk_main: the native host path is not on")
    pr64, _ = long_s.result(timeout=60)
    gs = load_saved_graph(np, csc, tmp, "stream")
    path = os.path.join(tmp, "disk.lux")
    t0 = time.perf_counter()
    how = fmt.write_lux_edges(path, gs.nv, gs.col_idx, gs.dst_of_edges())
    write_s = time.perf_counter() - t0
    nv, ne = gs.nv, gs.ne
    del gs
    require(how == "native", f"disk_main: the file was written by {how}")
    builds = host_builds(np, native_io, g, path)
    emit({"phase": "disk_main", "run": "host", "file": {"scale": STREAM_SCALE, "nv": nv,
          "ne": ne, "bytes": os.path.getsize(path), "write_s": write_s},
          "parts": DISK_PARTS, "builds": builds, "device": smi})

    launches, rows, ranks = {}, [], {}
    argv = ["-file", path, "-ng", str(DISK_PARTS), "--method", "mxscan", "-ni", str(ITERS),
            "--device", "cuda"]
    for label, flags in DISK_LAYOUTS:
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res, counts, wall = counted(kernels, pr_app.run, argv + flags)
        peak = torch.cuda.max_memory_allocated() - base_mem
        launches[f"pagerank-{label}"] = counts
        ranks[label] = res.ranks
        rel = float(np.max(np.abs(res.ranks.astype(np.float64) - pr64) / np.abs(pr64)))
        emit({"phase": "disk_main", "run": f"pagerank-{label}", "argv": flags, "rc": res.rc,
              "ms_per_iter": res.seconds * 1e3 / ITERS, "gteps": res.gteps,
              "max_rel_err_vs_f64": rel, "peak_bytes": peak, "launches": counts,
              "wall_seconds": wall, "device": smi})
        require(res.rc == 0 and bool(np.isfinite(res.ranks).all())
                and res.ranks.shape == (nv,), f"disk_main pagerank {label}: bad ranks")
        require(rel <= RANK_RTOL, f"disk_main pagerank {label}: off the f64 oracle by {rel}")
        require(counts["mxscan_segmented"] >= ITERS * DISK_PARTS,
                f"disk_main pagerank {label}: mxscan launched {counts['mxscan_segmented']}")
    require(np.array_equal(ranks["compact"], ranks["default"]),
            "disk_main: the compact layout's ranks differ from the direct layout's")
    require(np.array_equal(ranks["both"], ranks["sorted"]),
            "disk_main: sorted + compact differs from sorted")

    # the scan kernel on one part of the sorted and of the compact layout,
    # on the final ranks (the natively loaded part, relaid out here)
    one = sharded_load.load_pull_shards(path, DISK_PARTS, parts_subset=[0])
    full = torch.from_numpy(one.global_to_stacked(ranks["sorted"]).reshape(-1)).to(dev)
    for case in ("sorted", "compact"):
        arr = ShardArrays(*(a.copy() for a in one.arrays))
        if case == "sorted":
            sort_segments_inplace(arr)
        else:
            arr = build_compact_mirror(arr)
        a = to_device(arr, dev).part(0)
        vals = pull.gather_sources(a, full).contiguous()
        rows.append(scan_case(torch, scan, f"disk part 0, {case} layout, f32 sum", vals,
                              a.head_flag, a.row_ptr[-1:], "sum", reps))
    del one, full, arr, a, vals

    # SSSP and components on the main graph under the relayouts
    push_argv = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0", "-check",
                 "--device", "cuda", "--method", "mxscan"]
    for app, name, extra, want in ((sssp_app, "sssp", ["-start", str(start)], o_dist),
                                   (cc_app, "components", [], o_labels)):
        for label, flags in DISK_PUSH:
            res, counts, wall = counted(kernels, app.run, push_argv + extra + flags, graph=g)
            launches[f"{name}-{label}"] = counts
            emit({"phase": "disk_main", "run": f"{name}-{label}", "argv": flags, "rc": res.rc,
                  "iters": res.iters, "dense_rounds": res.dense_rounds, "gteps": res.gteps,
                  "ms": res.seconds * 1e3, "launches": counts, "wall_seconds": wall,
                  "device": smi})
            require(res.rc == 0, f"disk_main {name} {label}: -check failed")
            require(np.array_equal(res.state, want),
                    f"disk_main {name} {label}: differs from the push oracle")
            require(counts["mxscan_segmented"] >= max(res.dense_rounds, 1),
                    f"disk_main {name} {label}: mxscan launched {counts['mxscan_segmented']}")
    # the scan kernel on one dense round of the compact push layout (int32 min)
    psh = sssp_app.build_push_shards(g, 1, sort_segments=False, compact_gather=True)
    a = to_device(psh.arrays, dev).part(0)
    dist = torch.from_numpy(psh.pull.global_to_stacked(o_dist).reshape(-1)).to(dev)
    prog = sssp_model.SSSPProgram(nv=g.nv, start=start)
    vals = prog.relax(pull.gather_sources(a, dist), a.weights).contiguous()
    rows.append(scan_case(torch, scan, "push dense round, compact layout, int32 min", vals,
                          a.head_flag, a.row_ptr[-1:], "min", reps))
    del psh, a, dist, vals

    # --sort-segments --route-gather fused-pf on phase 4's plan, then one
    # iteration replayed with every routed launch held to its plain version
    g18 = load_saved_graph(np, csc, tmp, f"rmat{SORTED_SCALE}")  # phase 4's fifth process
    sh18 = build_pull_shards(g18, 1, sort_segments=True)
    t0 = time.perf_counter()
    plan = expand.plan_fused_shards_cached(sh18, "sum", cache_dir=plan_dir, pf=True)
    load_s = time.perf_counter() - t0
    res, counts, wall = counted(kernels, pr_app.run, [
        "--rmat-scale", str(SORTED_SCALE), "--rmat-ef", str(EF), "--seed", "0", "-ni",
        str(ITERS), "-check", "--device", "cuda", "--sort-segments", "--route-gather",
        "fused-pf"], route=plan, graph=g18)
    launches["pagerank-sorted-fused-pf"] = counts
    ref18 = pagerank_reference(g18, ITERS)
    rel = float(np.max(np.abs(res.ranks.astype(np.float64) - ref18) / np.abs(ref18)))
    held = {}
    prog = PageRankProgram(nv=g18.nv)
    arrays = to_device(sh18.arrays, dev)
    with held_kernels(torch, shuffle, ("lane_gather", "fused_pass_gather"), held):
        pull.run_pull_fixed(prog, sh18.spec, arrays, pull.init_state(prog, arrays), 1,
                            route=plan)
        torch.cuda.synchronize()
    emit({"phase": "disk_main", "run": "pagerank-sorted-fused-pf", "scale": SORTED_SCALE,
          "rc": res.rc, "route_gather": res.route_gather, "plan_load_s": load_s,
          "ms_per_iter": res.seconds * 1e3 / ITERS, "gteps": res.gteps,
          "max_rel_err_vs_f64": rel, "launches": counts, "held_launches": held,
          "wall_seconds": wall, "device": smi})
    require(res.rc == 0 and res.route_gather == "fused-pf",
            "disk_main: the sorted fused-pf run failed")
    require(rel <= RANK_RTOL, f"disk_main: sorted fused-pf off the f64 oracle by {rel}")
    require(counts["fused_pass_gather"] >= ITERS and counts["lane_gather"] >= ITERS,
            f"disk_main: sorted fused-pf launched {counts}")
    require(held.get("fused_pass_gather", 0) > 0 and held.get("lane_gather", 0) > 0,
            f"disk_main: the held replay launched {held}")
    # SSSP of the file at DISK_PARTS parts from its hub: phase dist's NCCL
    # push run must equal it bitwise
    hub22 = int(np.argmax(sharded_load.out_degrees_from_file(path)))
    res, counts, wall = counted(kernels, sssp_app.run, [
        "-file", path, "-ng", str(DISK_PARTS), "--method", "mxscan", "-start", str(hub22),
        "-check", "--device", "cuda"])
    launches["sssp-file"] = counts
    emit({"phase": "disk_main", "run": "sssp-file", "start": hub22, "rc": res.rc,
          "iters": res.iters, "dense_rounds": res.dense_rounds,
          "traversed_edges": res.traversed, "gteps": res.gteps, "ms": res.seconds * 1e3,
          "launches": counts, "wall_seconds": wall, "device": smi})
    require(res.rc == 0, "disk_main sssp-file: -check failed")
    require(counts["mxscan_segmented"] >= max(res.dense_rounds, 1),
            f"disk_main sssp-file: mxscan launched {counts['mxscan_segmented']}")
    sssp_file = {"start": hub22, "state": res.state, "iters": res.iters,
                 "traversed": res.traversed}
    del res
    total = {k: sum(c[k] for c in launches.values()) for k in kernels}
    emit({"phase": "disk_main", "kernels": rows, "launches": total,
          "seconds": time.perf_counter() - t_phase})
    return total, rows, {"path": path, "ranks": ranks["default"], "pr64": pr64,
                         "sssp": sssp_file}


DIST_RANKS = 2  # gloo ranks that share the card in runs (b)-(d)
DIST_PALLAS_PARTS = 2  # the block-CSR runs keep one part a rank
DIST_DEADLINE_S = 360.0  # a spawn group that outlives this is killed and fails the phase
DIST_KERNEL = {"allgather": "mxscan_segmented", "pallas": "spmv_blockcsr",
               "cf-app": "spmv_blockcsr_2d", "cf": "spmv_blockcsr_2d",
               "ring": "segment_sum_sorted", "scatter": "segment_sum_sorted"}
DIST_PUSH_PARTS = 4  # the gloo push runs: 2 ranks of 2 resident parts (pallas: 2 parts)
DIST_DELTA = 25  # the distributed --delta run's width (delta_main's first)
#: the 2-D grids: 4 gloo ranks on the card, 2 part rows x 2 edge or feat shards
DIST_GRID_RANKS, DIST_GRID_PARTS, DIST_GRID_SHARDS = 4, 2, 2
#: the routed legs (--route-gather under --distributed) run at RMAT 18 / ef 16
#: and the CF rating graph of scale 18: a depth cut, as SORTED_SCALE (plan
#: builds at RMAT 20 take 51-108 s a family on the card's host); phase 4's
#: seventh process (dist_plans) builds their plans into the cache the ranks load
DIST_ROUTED_SCALE = 18
#: the colorer threads of that process, which runs beside phases 17 and 9-14
DIST_PLAN_THREADS = 2
#: the kernel each routed leg must launch in every rank, by --route-gather mode
DIST_ROUTED_KERNEL = {"expand": "lane_gather", "expand-pf": "fused_pass_gather",
                      "fused-mx": "mxreduce_pass_gather"}


def dist_plans(tmp: str, plan_dir: str) -> dict:
    """Phase 4's seventh process: every plan family the routed legs of
    phase 25 load, built into the plan cache through the cached planners
    the ranks call, on the layouts the ranks build (the same per-part and
    per-bucket keys): on RMAT DIST_ROUTED_SCALE at DIST_PUSH_PARTS parts
    the expand and expand-pf plans (the pull and the push allgather), the
    fused-mx "sum" plan (every part's group template, which the ranks
    agree on), the ring and reduce-scatter bucket plans (the push ring's
    buckets are the pull ring's), and the 2 x 2 edge grid's cells; on the
    CF rating graph of that scale the CF plans at DIST_GRID_PARTS parts.
    The graphs are handed to the ranks under ``tmp``.  Returns each
    family's seconds and the SSSP leg's source (the largest out-degree)."""
    os.environ["LUX_ROUTE_THREADS"] = str(DIST_PLAN_THREADS)
    import numpy as np

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.ops import expand
    from lux_tpu_torch.parallel import edge2d, ring, scatter

    t_all = time.perf_counter()
    g = generate.rmat(DIST_ROUTED_SCALE, EF, seed=0)
    save_graph(np, tmp, f"dist{DIST_ROUTED_SCALE}", g)
    n_half = (1 << DIST_ROUTED_SCALE) // 2
    gcf = generate.bipartite_ratings(n_half, n_half, (1 << DIST_ROUTED_SCALE) * EF // 2, seed=0)
    save_graph(np, tmp, f"cf{DIST_ROUTED_SCALE}", gcf)
    sh = build_pull_shards(g, DIST_PUSH_PARTS)
    fams = (
        ("expand-pf", lambda: expand.plan_expand_shards_cached(sh, plan_dir, pf=True)),
        ("fused-mx", lambda: expand.plan_fused_shards_cached(sh, "sum", plan_dir, mx=True)),
        ("ring", lambda: expand.plan_ring_route_shards_cached(
            ring.build_ring_shards(g, DIST_PUSH_PARTS, pull=sh), plan_dir)),
        ("scatter", lambda: expand.plan_scatter_route_shards_cached(
            scatter.build_scatter_shards(g, DIST_PUSH_PARTS, pull=sh), plan_dir)),
        ("edge2d", lambda: expand.plan_edge2d_route_shards_cached(
            edge2d.build_edge2d_shards(g, DIST_GRID_PARTS, DIST_GRID_SHARDS), plan_dir)),
        ("cf", lambda: expand.plan_cf_route_shards_cached(
            build_pull_shards(gcf, DIST_GRID_PARTS), plan_dir)))
    seconds = {}
    for name, build in fams:
        t0 = time.perf_counter()
        build()
        seconds[name] = time.perf_counter() - t0
    return {"scale": DIST_ROUTED_SCALE, "parts": DIST_PUSH_PARTS, "seconds": seconds,
            "threads": DIST_PLAN_THREADS, "hub": int(np.argmax(g.out_degrees())),
            "plan_stats": expand.plan_stats_snapshot(),
            "wall_s": time.perf_counter() - t_all, "process_cpu_seconds": time.process_time()}


def dist_hold(torch, got, want64, what: str) -> float:
    """A kernel's f32 sum in a rank against the same sum in float64:
    rtol SUM_RTOL, else PhaseFailure.  Returns the max abs error."""
    diff = (got.double() - want64).abs()
    bad = diff > SUM_RTOL * want64.abs()
    require(not bool(bad.any()), f"dist: {what} outside rtol {SUM_RTOL} of float64 at "
                                 f"{int(bad.sum())} places")
    return float(diff.max()) if diff.numel() else 0.0


def dist_hold_kernels(torch, pg, pp, block, two_d: bool, reps: int) -> dict:
    """This rank's block-CSR kernel on its own part's slots, the values of
    the exchanged ``block``: the kernel against the same sum in float64
    (not a main-path launch: the caller read its counters before), and
    timed against its plain version and one index_add_."""
    from lux_tpu_torch.ops import spmv
    from lux_tpu_torch.parallel.mesh import shard_stacked
    from lux_tpu_torch.parallel.placement import halo_all_gather

    a = shard_stacked(pg, pp.arrays)
    e_dst, cb, cf = a.e_dst_rel[0], a.chunk_block[0], a.chunk_first[0]
    full = halo_all_gather(block, pg)
    vals = full.index_select(0, a.e_src_pos[0].reshape(-1)).float()
    n = pp.num_vblocks * pp.v_blk
    dst = spmv._flat_dst(e_dst, cb, pp.v_blk, n)
    if two_d:
        vals = vals.view(*e_dst.shape, -1).contiguous()
        k = vals.shape[-1]
        kern = lambda: spmv.spmv_blockcsr_2d(vals, e_dst, cb, cf, v_blk=pp.v_blk,  # noqa: E731
                                             num_vblocks=pp.num_vblocks)
        plain = lambda: spmv.spmv_blockcsr_2d_plain(vals, e_dst, cb, cf, pp.v_blk,  # noqa: E731
                                                    pp.num_vblocks)
        want = torch.zeros((n + 1, k), dtype=torch.float64, device=vals.device)
        want.index_add_(0, dst, vals.reshape(-1, k).double())
        lib = lambda: torch.zeros((n + 1, k), device=vals.device).index_add_(  # noqa: E731
            0, dst, vals.reshape(-1, k))
        name, nbytes = "spmv_blockcsr_2d", vals.numel() * 4 + e_dst.numel() * 4 + n * k * 4
    else:
        vals = vals.view(e_dst.shape).contiguous()
        kern = lambda: spmv.spmv_blockcsr(vals, e_dst, cb, cf, op="sum",  # noqa: E731
                                          v_blk=pp.v_blk, num_vblocks=pp.num_vblocks)
        plain = lambda: spmv.spmv_blockcsr_plain(vals, e_dst, cb, cf, "sum",  # noqa: E731
                                                 pp.v_blk, pp.num_vblocks)
        want = torch.zeros(n + 1, dtype=torch.float64, device=vals.device)
        want.index_add_(0, dst, vals.reshape(-1).double())
        lib = lambda: torch.zeros(n + 1, device=vals.device).index_add_(  # noqa: E731
            0, dst, vals.reshape(-1))
        name, nbytes = "spmv_blockcsr", vals.numel() * 8 + n * 4
    err = dist_hold(torch, kern(), want[:n], f"{name} on rank {pg.rank}'s part")
    return {"kernel": name, "shape": list(vals.shape), "max_abs_err": err,
            "kernel_ms": time_ms(torch, kern, reps), "plain_ms": time_ms(torch, plain, reps),
            "library_ms": time_ms(torch, lib, reps), "bound_ms": bound_ms(nbytes)}


def dist_hold_push_spmv(torch, lay, block, reps: int) -> dict:
    """Kernel 1 in the program's int32 min or max on this rank's part of
    the block-CSR push layout ``lay`` (the dense round's relaxed slot
    values of the exchanged final ``block``): bitwise its plain version,
    timed beside it and one scatter_reduce_ amin / amax; bound C*T*8 +
    nv_pad*4 bytes."""
    from lux_tpu_torch.ops import spmv
    from lux_tpu_torch.parallel.placement import halo_all_gather

    pg, sh, prog, part = lay.pg, lay.shards, lay.prog, lay.statics
    full = halo_all_gather(block, pg)
    shape = part.e_dst_rel.shape
    vals = prog.relax(full.index_select(0, part.e_src_flat).view(shape),
                      part.e_weight).contiguous()
    op, n = prog.reduce, sh.num_vblocks * sh.v_blk
    args = (vals, part.e_dst_rel, part.chunk_block, part.chunk_first)
    kern = functools.partial(spmv.spmv_blockcsr, *args, op=op, v_blk=sh.v_blk,
                             num_vblocks=sh.num_vblocks)
    plain = functools.partial(spmv.spmv_blockcsr_plain, *args, op, sh.v_blk, sh.num_vblocks)
    dst = spmv._flat_dst(part.e_dst_rel, part.chunk_block, sh.v_blk, n)
    neutral = spmv.reduce_neutral(op, torch.int32)
    lib = lambda: torch.full((n + 1,), neutral, dtype=torch.int32,  # noqa: E731
                             device=vals.device).scatter_reduce_(
        0, dst, vals.reshape(-1), reduce="amin" if op == "min" else "amax")
    got, want = kern(), plain()
    torch.cuda.synchronize()
    require(torch.equal(got, want) and torch.equal(got, lib()[:n]),
            f"dist: spmv_blockcsr int32 {op} on rank {pg.rank}'s push part differs from "
            "its plain version")
    nbytes = vals.numel() * 8 + sh.spec.nv_pad * 4
    return {"kernel": "spmv_blockcsr", "case": f"push part, int32 {op}", "op": op,
            "dtype": "int32", "shape": list(shape), "max_abs_err": 0.0,
            "kernel_ms": time_ms(torch, kern, reps), "plain_ms": time_ms(torch, plain, reps),
            "library_ms": time_ms(torch, lib, reps), "bound_ms": bound_ms(nbytes),
            "bytes": nbytes}


def dist_hold_push_scan(torch, lay, block, reps: int) -> dict:
    """Kernel 2 in int32 min at a rank's dense round of the allgather
    push layout ``lay``: its first resident part's relaxed in-edge values
    of the exchanged final ``block``, through scan_case (bitwise its
    plain version, timed beside it and its bound)."""
    from lux_tpu_torch.engine import pull
    from lux_tpu_torch.ops import scan
    from lux_tpu_torch.parallel.placement import halo_all_gather

    pg = lay.pg
    full = halo_all_gather(block, pg)
    a = lay.arrays.part(0)
    vals = lay.prog.relax(pull.gather_sources(a, full), a.weights).contiguous()
    return scan_case(torch, scan, f"rank {pg.rank} push part, dense round int32 min", vals,
                     a.head_flag, a.row_ptr[-1:], "min", reps)


def dist_push_split(lay, delta: int):
    """ms an iteration of one more fenced run of the push app's placed
    layout ``lay`` to convergence (``delta``: the delta-stepping width, or
    0), split into compute, staging and collective."""
    from lux_tpu_torch.apps import common
    from lux_tpu_torch.engine import delta as delta_eng

    if delta:
        return common.push_exchange_split(lay.pg, lambda: delta_eng.run_window(
            lay, delta, delta_eng.init_on(lay, delta), 10_000))
    return common.push_exchange_split(lay.pg, lambda: lay.loop(lay.init(), 10_000))


def dist_hold_routed(torch, shuffle, name: str, replay, reps: int) -> dict:
    """The routed kernel ``name`` held on this rank's plan slice: ``replay()``
    (one more iteration, or dense round, of the leg on its final state;
    a collective every rank takes) runs with the kernel's launches
    captured, not counted; the largest launch's inputs then go through
    the kernel and its plain version: gathers bitwise, the mx kernel's f32
    sum against float64 within SUM_RTOL (its min / max / int32 bitwise);
    timed beside the plain version and, for lane_gather, torch.gather;
    bound: the bytes the launch moves."""
    orig, calls = getattr(shuffle, name), []

    def spy(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)
    # the wrapper counts its launches by its module name, which is the
    # spy's while it is in place: the kernels' own counters stay untouched
    spy.launches = 0
    setattr(shuffle, name, spy)
    try:
        replay()
        torch.cuda.synchronize()
    finally:
        setattr(shuffle, name, orig)
    require(bool(calls), f"dist: {name} was not launched in the rank's routed replay")
    a, kw = max(calls, key=lambda c: c[0][0].numel())
    plain = getattr(shuffle, f"{name}_plain")
    got, want = orig(*a, **kw), plain(*a, **kw)
    x = a[0]
    lib = None
    if name == "mxreduce_pass_gather":
        y, idx, dst_rel, tile_block = a[:4]
        g = a[4] if len(a) > 4 else kw["group"]
        if g.op == "sum" and y.dtype == torch.float32:
            want = mx_sum_f64(torch, shuffle, y, idx, dst_rel, tile_block, g)
        err = compare(torch, got, want, g.op != "sum" or y.dtype != torch.float32,
                      what=f"dist {name}")
        nbytes = (y.numel() * (4 + len(idx) * idx[0].element_size() + dst_rel.element_size())
                  + g.num_blocks * g.v_blk * 4)
    else:
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"dist: {name} differs from its plain version on "
                                        "the rank's plan slice")
        err = 0.0
        if name == "lane_gather":
            idx = a[1]
            idx64 = idx.long()
            lib = lambda: torch.gather(x, 1, idx64)  # noqa: E731
            nbytes = x.numel() * (2 * x.element_size() + idx.element_size())
        else:
            idx = a[1]
            nbytes = x.numel() * (2 * x.element_size() + len(idx) * idx[0].element_size())
    return {"kernel": name, "shape": list(x.shape), "launches_in_replay": len(calls),
            "max_abs_err": err, "kernel_ms": time_ms(torch, lambda: orig(*a, **kw), reps),
            "plain_ms": time_ms(torch, lambda: plain(*a, **kw), max(2, reps // 4)),
            "library_ms": None if lib is None else time_ms(torch, lib, reps),
            "bound_ms": bound_ms(nbytes), "bytes": nbytes}


def dist_routed_leg(torch, np, pg, argv: list, opt: dict, tmp: str) -> dict:
    """One routed leg of phase dist in this rank: ``apps.<app>.run(argv)``
    (--route-gather under --distributed) on the graph phase 4's seventh
    process saved, its launches and plan-cache counts read just after;
    then its direct twin on the same shard build in this process (the
    app's DistSetup without its plan, ITERS iterations from the initial
    block; or the push layout placed again without it, to convergence),
    with ``opt["single"]`` rank 0's single-process routed run over every
    part's plan (loaded from the cache), the exchange's split, and the
    leg's kernel held on this rank's plan slice."""
    import importlib

    from lux_tpu_torch.engine import pull, push
    from lux_tpu_torch.graph import csc
    from lux_tpu_torch.graph.shards import to_device
    from lux_tpu_torch.ops import expand, shuffle
    from lux_tpu_torch.parallel import spawn

    app = importlib.import_module(f"lux_tpu_torch.apps.{opt['app']}")
    g = load_saved_graph(np, csc, tmp, opt["graph"])
    expand.reset_plan_stats()
    t0 = time.perf_counter()
    res = app.run(argv, graph=g)
    torch.cuda.synchronize()
    row = {"rc": res.rc, "seconds": res.seconds, "gteps": res.gteps, "iters": res.iters,
           "launches": spawn.kernel_launches(), "plans": expand.plan_stats_snapshot(),
           "wall_s": time.perf_counter() - t0}
    kernel = DIST_ROUTED_KERNEL[argv[argv.index("--route-gather") + 1]]
    if opt["app"] in ("sssp", "components"):
        lay, final = res.dist[0], res.dist[1]
        row.update(traversed=res.traversed, dense_rounds=res.dense_rounds,
                   state=lay.read(final.state))
        twin = push.place_layout(lay.prog, lay.shards, lay.pg, lay.method, merge=lay.merge)
        tw = twin.loop(twin.init(), 10_000)
        row.update(twin=twin.read(tw.state), twin_iters=int(tw.it), twin_traversed=int(tw.edges))
        twin.release()
        row["exchange"] = dist_push_split(lay, 0)
        row["held"] = dist_hold_routed(torch, shuffle, kernel, lambda: lay.dense_fn(final.state),
                                       REPS)
        return row
    ds, block = res.dist
    row["state"] = res.ranks if opt["app"] == "pagerank" else res.state
    direct = dataclasses.replace(ds, route=None)
    tb = ds.initial()
    direct.iterate(tb, ITERS)
    row["twin"] = direct.read(tb)
    del tb, direct
    if opt.get("single") and pg.rank == 0:
        sh = ds.layout
        plan = expand.plan_fused_shards_cached(sh, "sum", mx=True)
        arrays = to_device(sh.arrays, pg.device)
        out = pull.run_pull_fixed(ds.prog, sh.spec, arrays, pull.init_state(ds.prog, arrays),
                                  ITERS, ds.method, route=plan)
        row["single"] = sh.scatter_to_global(out.float().cpu().numpy())
        del plan, arrays, out
    row["exchange"] = ds.exchange_split(block, ITERS)
    row["held"] = dist_hold_routed(torch, shuffle, kernel,
                                   lambda: ds.iterate(block.clone(), 1), REPS)
    return row


def dist_routed_check(np, label: str, argv: list, per_rank: list) -> dict:
    """A routed leg against its direct twin in the same ranks: every
    rank's exit code 0, no plan built cold (every entry loaded from phase
    4's cache), the leg's kernel launched in every rank (ITERS times an
    iteration's worth at least: once an iteration, or a dense round of
    the push); the pull legs' state bitwise the twin's (fused-mx: within
    SUM_RTOL of rank 0's single-process routed run), the push legs'
    state, iterations and traversed edges bitwise."""
    lead = per_rank[0]
    mode = argv[argv.index("--route-gather") + 1]
    kernel = DIST_ROUTED_KERNEL[mode]
    require(all(r["rc"] == 0 for r in per_rank), f"dist {label}: a rank's -check failed")
    for r in per_rank:
        require(r["plans"]["built"] == 0 and r["plans"]["loaded"] > 0,
                f"dist {label}: a rank built its plan cold: {r['plans']}")
    push_leg = "traversed" in lead
    need = max(lead["dense_rounds"], 1) if push_leg else ITERS
    got = [r["launches"][kernel] for r in per_rank]
    require(all(n >= need for n in got),
            f"dist {label}: {kernel} launched {got} times in the ranks (need {need} each)")
    if not push_leg and "--method" in argv and argv[argv.index("--method") + 1] == "scatter":
        sums = [r["launches"]["segment_sum_sorted"] for r in per_rank]
        require(all(n >= ITERS for n in sums),
                f"dist {label}: segment_sum_sorted launched {sums} times in the ranks")
    state = lead["state"]
    require(state is not None and bool(np.isfinite(state).all()),
            f"dist {label}: no finite state on rank 0")
    out = {"kernel": kernel, "mode": mode, "plans_loaded": [r["plans"]["loaded"]
                                                            for r in per_rank]}
    if push_leg:
        require(np.array_equal(state, lead["twin"]),
                f"dist {label}: rank 0's state differs from the direct twin's")
        for r in per_rank:
            require((r["iters"], r["traversed"]) == (r["twin_iters"], r["twin_traversed"]),
                    f"dist {label}: (iterations, edges) {(r['iters'], r['traversed'])} differ "
                    f"from the direct twin's {(r['twin_iters'], r['twin_traversed'])}")
        out.update(bitwise_direct_twin=True, iters=lead["iters"],
                   traversed_edges=lead["traversed"], dense_rounds=lead["dense_rounds"])
        return out
    if "single" in lead:
        single = lead["single"]
        rel = float(np.max(np.abs(state.astype(np.float64) - single) / np.abs(single)))
        require(rel <= SUM_RTOL, f"dist {label}: off the single-process routed run by {rel}")
        out.update(max_rel_err_vs_single_process=rel,
                   bitwise_single_process=bool(np.array_equal(state, single)),
                   max_rel_err_vs_direct_twin=float(np.max(
                       np.abs(state.astype(np.float64) - lead["twin"]) / np.abs(lead["twin"]))))
        return out
    require(np.array_equal(state, lead["twin"]),
            f"dist {label}: rank 0's state differs from the direct twin's")
    out["bitwise_direct_twin"] = True
    return out


def routed_legs(hub: int):
    """The routed legs of phase dist, (the 2-rank group's, the grid's):
    (label, "routed", argv, options), on RMAT DIST_ROUTED_SCALE (SSSP from
    its vertex ``hub``) and the CF rating graph of that scale, every plan
    loaded from phase 4's cache."""
    g18 = ["--rmat-scale", str(DIST_ROUTED_SCALE), "--rmat-ef", str(EF), "--seed", "0",
           "--distributed", "--device", "cuda"]
    pr18 = g18 + ["-ng", str(DIST_PUSH_PARTS), "-ni", str(ITERS), "-check"]
    push18 = g18 + ["-ng", str(DIST_PUSH_PARTS), "-check"]
    on18 = {"app": "pagerank", "graph": f"dist{DIST_ROUTED_SCALE}"}
    routed_b = [
        ("routed-ag-expand-pf", "routed", pr18 + ["--method", "mxscan", "--route-gather",
                                                  "expand-pf"], on18),
        ("routed-ag-fused-mx", "routed", pr18 + ["--method", "mxscan", "--route-gather",
                                                 "fused-mx"], dict(on18, single=True)),
        # --method scatter: the float sums go through the sorted-key kernel
        # (segment_sum_sorted), bitwise between runs like every other leg
        ("routed-ring", "routed", pr18 + ["--exchange", "ring", "--method", "scatter",
                                          "--route-gather", "expand"], on18),
        ("routed-scatter", "routed", pr18 + ["--exchange", "scatter", "--method", "scatter",
                                             "--route-gather", "expand"], on18),
        ("routed-sssp", "routed", push18 + ["--method", "mxscan", "-start",
                                            str(hub), "--route-gather", "expand"],
         dict(on18, app="sssp")),
        ("routed-cc-ring", "routed", push18 + ["--exchange", "ring", "--method", "scatter",
                                               "--route-gather", "expand"],
         dict(on18, app="components"))]
    routed_e = [
        ("routed-edge2d", "routed", g18 + ["-ng", str(DIST_GRID_PARTS), "-ni", str(ITERS),
                                           "-check", "--edge-shards", str(DIST_GRID_SHARDS),
                                           "--method", "scan", "--route-gather", "expand"],
         on18),
        ("routed-feat", "routed", [a for a in cf_argv(DIST_ROUTED_SCALE) if a != "-check"] + [
            "-ng", str(DIST_GRID_PARTS), "--feat-shards", str(DIST_GRID_SHARDS),
            "--distributed", "--route-gather", "expand"],
         {"app": "colfilter", "graph": f"cf{DIST_ROUTED_SCALE}"})]
    return routed_b, routed_e


def dist_rank(pg, runs, tmp):
    """One rank of phase dist: each run of ``runs`` in order, with this
    process's launch counters set to 0 just before and read just after.
    A "pagerank" run is ``apps.pagerank.run(argv)`` (with -file each rank
    loads only its parts' byte ranges); "pallas" the same on the main
    graph, handed over from the smoke's scratch directory, then the
    kernel held on this rank's part; "cf-app" ``apps.colfilter.run(argv)``
    on the rating graph; "cf" the distributed CF library
    (parallel/pallas_dist.run_cf_pallas_dist at gamma CF_GAMMA, through
    apps/common.DistSetup) on the rating graph, timed after an untimed
    run as the apps time, then its kernel held.  After each run (its
    launches read) DistSetup.exchange_split times ITERS more iterations.
    A "sssp" or "components" run is the push app's ``run(argv)`` on the
    graph its options name (``graph``: a saved one, else -file), under
    their ``env``, then (``split``) one more fenced run to convergence for
    the exchange's split, then the kernel its ``hold`` names held on this
    rank's part.  A "run" run is ``apps.run.run(argv)`` on the main graph;
    "edge2d" ``apps.pagerank.run(argv)`` on the main graph and "feat"
    ``apps.colfilter.run(argv)`` on the rating graph with the program's
    step at CF_GAMMA, each then timing its split on a further fenced run.
    Returns {label: {"state" (rank 0), "seconds", "launches", ...}}."""
    import numpy as np
    import torch

    from lux_tpu_torch.apps import colfilter as cf_app
    from lux_tpu_torch.apps import common
    from lux_tpu_torch.apps import pagerank as pr_app
    from lux_tpu_torch.graph import csc
    from lux_tpu_torch.models import colfilter as cf_model
    from lux_tpu_torch.parallel import multihost, pallas_dist, spawn
    from lux_tpu_torch.parallel.mesh import make_parts_group, shard_stacked

    from lux_tpu_torch.apps import components as cc_app
    from lux_tpu_torch.apps import sssp as sssp_app

    out = {}
    for label, kind, argv, *opt in runs:
        opt = opt[0] if opt else {}
        torch.cuda.synchronize()
        spawn.reset_launches()
        t0 = time.perf_counter()
        row = {}
        if kind == "routed":
            out[label] = dist_routed_leg(torch, np, pg, argv, opt, tmp)
            continue
        if kind == "run":
            # a spec workload through apps/run.py on the main graph
            from lux_tpu_torch.apps import run as run_app

            res = run_app.run(argv, graph=load_saved_graph(np, csc, tmp, "main"))
            torch.cuda.synchronize()
            row.update(state=res.state if pg.rank == 0 else None, seconds=res.seconds,
                       gteps=res.gteps, rc=res.rc, iters=res.iters, stats=res.stats,
                       launches=spawn.kernel_launches(), wall_s=time.perf_counter() - t0)
            del res
            out[label] = row
            continue
        if kind in ("edge2d", "feat"):
            # the 2-D grids through the apps: PageRank on the main graph,
            # CF on the rating graph with the accuracy runs' step
            if kind == "edge2d":
                res = pr_app.run(argv, graph=load_saved_graph(np, csc, tmp, "main"))
                state = res.ranks
            else:
                plain_program = cf_app.program
                cf_app.program = lambda cfg: cf_model.CFProgram(
                    dtype=cfg.dtype, err_dot=cf_model._resolve_err_dot(None), gamma=CF_GAMMA)
                try:
                    res = cf_app.run(argv, graph=load_saved_graph(np, csc, tmp, "cf"))
                finally:
                    cf_app.program = plain_program
                state = res.state
            torch.cuda.synchronize()
            ds, block = res.dist
            row.update(state=state, seconds=res.seconds, gteps=res.gteps, rc=res.rc,
                       launches=spawn.kernel_launches(), wall_s=time.perf_counter() - t0)
            row["exchange"] = ds.exchange_split(block, ITERS)
            del res, ds, block
            out[label] = row
            continue
        if kind in ("sssp", "components"):
            # the distributed push through the app; the graph handed over
            # from the smoke's scratch directory (or -file)
            g = load_saved_graph(np, csc, tmp, opt["graph"]) if opt.get("graph") else None
            saved = {k: os.environ.get(k) for k in opt.get("env", {})}
            os.environ.update(opt.get("env", {}))
            try:
                res = (sssp_app if kind == "sssp" else cc_app).run(argv, graph=g)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            torch.cuda.synchronize()
            row.update(state=res.state, seconds=res.seconds, gteps=res.gteps, rc=res.rc,
                       iters=res.iters, traversed=res.traversed,
                       dense_rounds=res.dense_rounds, recuts=len(res.recuts or ()),
                       launches=spawn.kernel_launches(), wall_s=time.perf_counter() - t0)
            lay, final = res.dist[0], res.dist[1]
            row["exchange"] = None
            if opt.get("split"):
                delta_w = int(argv[argv.index("--delta") + 1]) if "--delta" in argv else 0
                row["exchange"] = dist_push_split(lay, delta_w)
            hold = opt.get("hold")
            if hold == "spmv":
                row["held"] = dist_hold_push_spmv(torch, lay, final.state, REPS)
            elif hold == "scan":
                row["held"] = dist_hold_push_scan(torch, lay, final.state, REPS)
            del res, lay, final
            out[label] = row
            continue
        if kind in ("pagerank", "pallas", "cf-app"):
            g = (load_saved_graph(np, csc, tmp, {"pallas": "main", "cf-app": "cf"}[kind])
                 if kind != "pagerank" else None)
            res = (cf_app if kind == "cf-app" else pr_app).run(argv, graph=g)
            ds, block = res.dist
            row.update(state=res.state if kind == "cf-app" else res.ranks,
                       seconds=res.seconds, gteps=res.gteps, rc=res.rc)
            del res
        else:
            g = load_saved_graph(np, csc, tmp, "cf")
            cpg = make_parts_group(DIST_PALLAS_PARTS, pg.device)
            pp = pallas_dist.build_pallas_parts(g, DIST_PALLAS_PARTS, parts_subset=[pg.rank])
            pp = dataclasses.replace(pp, arrays=shard_stacked(cpg, pp.arrays))
            prog = cf_model.CFProgram(gamma=CF_GAMMA)
            ds = common.DistSetup(prog, cpg, pp, "allgather", "pallas", True)
            block = pallas_dist.init_state_pallas(prog, pp).to(pg.device)
            secs = common.timed_iterations(ds.iterate, block, ITERS, pg.device, cpg.barrier)
            st = multihost.assemble_global(cpg, block)
            row.update(state=None if st is None else pp.scatter_to_global(st), seconds=secs,
                       gteps=ITERS * g.ne / secs / 1e9, rc=0)
        torch.cuda.synchronize()
        row["launches"] = spawn.kernel_launches()
        row["wall_s"] = time.perf_counter() - t0
        row["exchange"] = ds.exchange_split(block, ITERS)
        if kind == "pallas":
            hpg = make_parts_group(DIST_PALLAS_PARTS, pg.device)
            pp = pallas_dist.build_pallas_parts(g, DIST_PALLAS_PARTS, parts_subset=[pg.rank])
            from lux_tpu_torch.models.pagerank import PageRankProgram

            s0 = pallas_dist.init_state_pallas(PageRankProgram(nv=g.nv), pp).to(pg.device)
            row["held"] = dist_hold_kernels(torch, hpg, pp, s0, False, REPS)
        elif kind == "cf":
            row["held"] = dist_hold_kernels(torch, cpg, pp, block, True, REPS)
        del ds, block
        out[label] = row
    return out


def dist_push_check(np, label: str, kind: str, argv: list, per_rank: list, want: dict):
    """A distributed push run against its single-process counterpart: rank
    0's state bitwise, every rank's iterations and traversed edges equal
    to it, every rank's exit code 0, and the run's kernel launched at
    least once a dense round in every rank (mxscan, or the block-CSR
    kernel under --method pallas; the ring's scatter method runs none)."""
    lead = per_rank[0]
    require(lead["state"] is not None and np.array_equal(lead["state"], want["state"]),
            f"dist {label}: rank 0's state differs from the single-process run")
    for r in per_rank:
        require((r["iters"], r["traversed"]) == (want["iters"], want["traversed"]),
                f"dist {label}: (iterations, edges) {(r['iters'], r['traversed'])} differ "
                f"from the single-process run's {(want['iters'], want['traversed'])}")
        require(r["rc"] == 0, f"dist {label}: a rank's -check failed")
    kernel = ("spmv_blockcsr" if "pallas" in argv else
              "mxscan_segmented" if "mxscan" in argv else None)
    if kernel:
        need = max(lead["dense_rounds"], 1)
        require(all(r["launches"][kernel] >= need for r in per_rank),
                f"dist {label}: {kernel} launched {[r['launches'][kernel] for r in per_rank]} "
                f"times in the ranks over {need} dense rounds")
    return {"bitwise_single_process": True, "iters": lead["iters"],
            "traversed_edges": lead["traversed"], "dense_rounds": lead["dense_rounds"],
            "kernel": kernel}


def dist_workload_check(np, label: str, per_rank: list, want: dict, g_nv: int):
    """A distributed spec workload run (apps/run.py --distributed) against
    phase 11's single-process run: bfs and kcore bitwise in distances or
    coreness, iterations (peel rounds) and, for the push, traversed edges
    and dense rounds; labelprop within LP_RTOL / LP_ATOL of the float64
    oracle; every rank's exit code 0; kernel 2 launched at least once a
    dense round (the push) or an iteration (the pull-until rounds, the
    peel's rounds) in every rank, on the mxscan runs."""
    lead = per_rank[0]
    state = lead["state"]
    require(state is not None, f"dist {label}: no state on rank 0")
    require(all(r["rc"] == 0 for r in per_rank), f"dist {label}: a rank's -check failed")
    out = {}
    if label == "labelprop":
        err = float(np.max(np.abs(state - want["labelprop64"])))
        require(bool(np.isfinite(state).all())
                and np.allclose(state, want["labelprop64"], rtol=LP_RTOL, atol=LP_ATOL),
                f"dist labelprop: off the float64 oracle by {err}")
        return {"max_abs_err_vs_f64": err, "rtol": LP_RTOL, "atol": LP_ATOL}
    ref = want[{"bfs-pull": "bfs-pull", "kcore": "kcore"}.get(label, "bfs")]
    require(np.array_equal(state, ref["state"]),
            f"dist {label}: rank 0's state differs from phase 11's single-process run")
    for r in per_rank:
        require(r["iters"] == ref["iters"],
                f"dist {label}: {r['iters']} iterations, phase 11's run {ref['iters']}")
        if label.startswith("bfs-push") or label == "kcore":
            require(r["stats"] == ref["stats"],
                    f"dist {label}: stats {r['stats']} differ from phase 11's {ref['stats']}")
    out.update(bitwise_single_process=True, iters=lead["iters"], stats=lead["stats"],
               reached=int((state < g_nv).sum()) if label.startswith("bfs") else None)
    if "ring" not in label:  # the ring push runs the scatter method: no kernel
        need = max(lead["stats"].get("dense_rounds", lead["iters"]), 1)
        got = [r["launches"]["mxscan_segmented"] for r in per_rank]
        require(all(n >= need for n in got),
                f"dist {label}: mxscan_segmented launched {got} times in the ranks over "
                f"{need} rounds")
        out["kernel"] = "mxscan_segmented"
    return out


def dist_main(torch, np, kernels, smi, tmp, disk, pr_ref20, cf_pallas20, v64, push_ref,
              spec_ref, plan_dir, routed_plans):
    """Phase dist: the distributed pull and push engines (parallel/,
    engine/push) as ranks that share the card.  (a) NCCL, one rank holding the 8 parts of the RMAT
    22 file: allgather + mxscan PageRank, bitwise the single-process
    ``-ng 8`` run of disk_main; (b) gloo, 2 ranks, 4 parts each:
    allgather + mxscan (bitwise the same run), ring and scatter (--method
    scatter; within RANK_RTOL of the float64 oracle); (c) gloo, 2 ranks,
    ``--method pallas`` on the main graph at 2 parts (within RANK_RTOL of
    float64); (d) gloo, 2 ranks, ``apps.colfilter --distributed --method
    pallas -ng 2 -check`` on the 2-D kernel (within CF_RTOL of phase 8's
    single-process pallas run, ``cf_pallas20``), then the CF library at
    gamma CF_GAMMA (within CF_RTOL of cf_oracle_f64).  Then the push
    runs of each group (the module docstring, phase 25), each held by
    dist_push_check to its single-process twin in ``push_ref`` (or
    ``disk["sssp"]``), and the spec workloads through ``apps.run
    --distributed`` (bfs push over allgather and ring, bfs pull-until,
    kcore, labelprop), held by dist_workload_check to phase 11's runs
    (``spec_ref``).  (e) gloo, DIST_GRID_RANKS ranks as a 2 x 2 grid: the
    2-D meshes through the apps, PageRank ``--edge-shards 2 -ng 2
    --method scan`` within RANK_RTOL of the float64 oracle ``pr_ref20``,
    and CF ``--feat-shards 2 -ng 2`` over allgather and ring at gamma
    CF_GAMMA within CF_RTOL of ``v64``, each with its split on the lead
    rank.  Every rank's counters must show its kernel
    launched on the run and every rank's exit code must be 0; each run
    prints ms an iteration, and one push run of each exchange (and every
    pull run) its split into compute, staging and collective.
    Returns (launches summed over every rank and run, kernel rows)."""
    from lux_tpu_torch.parallel import spawn

    t_phase = time.perf_counter()
    before = {pid for pid, _ in child_processes()}
    path, want_default, pr64 = disk["path"], disk["ranks"], disk["pr64"]
    file_argv = ["-file", path, "-ng", str(DISK_PARTS), "-ni", str(ITERS), "--distributed",
                 "--device", "cuda"]
    pallas_argv = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0", "-ni",
                   str(ITERS), "-ng", str(DIST_PALLAS_PARTS), "--method", "pallas",
                   "--distributed", "--device", "cuda"]
    # the distributed push: SSSP and components through the apps
    hub, tail = str(push_ref["sssp"]["start"]), push_ref["tail"]
    sf = disk["sssp"]
    main = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0",
            "--distributed", "--device", "cuda", "-check"]
    ng = ["-ng", str(DIST_PUSH_PARTS)]
    ngp = ["-ng", str(DIST_PALLAS_PARTS), "--method", "pallas"]
    bfs_src = ["--sources", ",".join(map(str, spec_ref["sources"]))]
    main_pr = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0", "-ni",
               str(ITERS), "--distributed", "--device", "cuda", "-check"]
    # no -check on the CF runs: they are held to the float64 oracle, and
    # check_training's float64 pass over 16.8 M ratings is host seconds
    grid_cf = [a for a in cf_argv(SCALE) if a != "-check"] + [
        "-ng", str(DIST_GRID_PARTS), "--feat-shards", str(DIST_GRID_SHARDS), "--distributed"]
    routed_b, routed_e = routed_legs(routed_plans["hub"])
    push_want = {
        "push-nccl": sf, "push-allgather": push_ref["sssp"], "push-tree": push_ref["sssp"],
        "cc-allgather": push_ref["components"], "cc-ring": push_ref["components"],
        "sssp-pallas": push_ref["sssp"], "cc-pallas": push_ref["components"], "push-delta": push_ref["delta"],
        "push-repart": tail}
    groups = (
        ("a", "nccl", 1, [
            ("allgather-nccl", "pagerank", file_argv + ["--method", "mxscan"]),
            ("push-nccl", "sssp", ["-file", path, "-ng", str(DISK_PARTS), "--distributed",
                                   "--device", "cuda", "--method", "mxscan", "-start",
                                   str(sf["start"]), "-check"], {})]),
        ("b-d", "gloo", DIST_RANKS, [
            ("allgather", "pagerank", file_argv + ["--method", "mxscan"]),
            ("ring", "pagerank", file_argv + ["--exchange", "ring", "--method", "scatter"]),
            ("scatter", "pagerank", file_argv + ["--exchange", "scatter",
                                                  "--method", "scatter"]),
            ("pallas", "pallas", pallas_argv),
            ("cf-app", "cf-app", cf_argv(SCALE) + [
                "-ng", str(DIST_PALLAS_PARTS), "--method", "pallas", "--distributed"]),
            ("cf", "cf", []),
            # the fenced split on one run of each exchange: allgather, ring, pallas
            ("push-allgather", "sssp", main + ng + ["--method", "mxscan", "-start", hub],
             {"graph": "main", "hold": "scan", "split": True}),
            ("push-tree", "sssp", main + ng + ["--method", "mxscan", "-start", hub],
             {"graph": "main", "env": {"LUX_MERGE_MODE": "tree"}}),
            ("cc-allgather", "components", main + ng + ["--method", "mxscan"],
             {"graph": "main"}),
            ("cc-ring", "components", main + ng + ["--exchange", "ring", "--method",
                                                   "scatter"], {"graph": "main", "split": True}),
            ("sssp-pallas", "sssp", main + ngp + ["-start", hub],
             {"graph": "main", "hold": "spmv", "split": True}),
            ("cc-pallas", "components", main + ngp, {"graph": "main", "hold": "spmv"}),
            ("push-delta", "sssp", main + ng + ["--method", "mxscan", "--weighted", "--delta",
                                                str(DIST_DELTA), "-start", hub],
             {"graph": "weighted"}),
            # windows of one round, whose first (one vertex's out-edges)
            # recuts, as repart_main's second SSSP run
            ("push-repart", "sssp", main + ng + [
                "--method", "mxscan", "-start", str(tail["start"]), "--repartition-every",
                "1", "--repartition-threshold", str(REPART_THRESHOLD)],
             {"graph": "main"}),
            # the spec workloads' mesh drivers (apps/run.py --distributed)
            ("bfs-push", "run", ["bfs"] + main + ng + bfs_src + ["--method", "mxscan"]),
            ("bfs-push-ring", "run", ["bfs"] + main + ng + bfs_src + [
                "--exchange", "ring", "--method", "scatter"]),
            ("bfs-pull", "run", ["bfs"] + main + ng + bfs_src + [
                "--engine", "pull", "--method", "mxscan"]),
            ("kcore", "run", ["kcore"] + main + ng + ["--method", "mxscan"]),
            ("labelprop", "run", ["labelprop"] + main + ng + [
                "-ni", str(ITERS), "--labels", str(LP_LABELS), "--seed-stride",
                str(LP_STRIDE)])] + routed_b),
        ("e", "gloo", DIST_GRID_RANKS, [
            ("edge2d", "edge2d", main_pr + ["-ng", str(DIST_GRID_PARTS), "--edge-shards",
                                            str(DIST_GRID_SHARDS), "--method", "scan"]),
            ("feat", "feat", grid_cf),
            ("feat-ring", "feat", grid_cf + ["--exchange", "ring"])] + routed_e))
    total = {k: 0 for k in kernels}
    rows = []
    for name, backend, world, runs in groups:
        t0 = time.perf_counter()
        try:
            res = spawn.run_ranks(world, dist_rank, (runs, tmp), num_parts=world,
                                  device="cuda", backend=backend,
                                  deadline_s=DIST_DEADLINE_S, threads=8 // max(world, 2),
                                  env={"LUX_DIST_BACKEND": backend,
                                       "LUX_TORCH_PLAN_CACHE": plan_dir})
        except spawn.RankFailure as e:
            raise PhaseFailure(f"dist {name}: {e}")
        for label, kind, argv, *_ in runs:
            per_rank = [r["result"][label] for r in res]
            lead = per_rank[0]
            launches = [r["launches"] for r in per_rank]
            for c in launches:
                for k in total:
                    total[k] += c.get(k, 0)
            if kind == "routed":
                err = dist_routed_check(np, label, argv, per_rank)
                held = [r["held"] for r in per_rank]
                rows += held
                emit({"phase": "dist", "run": label, "group": name, "backend": backend,
                      "ranks": world, "argv": argv, **err,
                      "ms_per_iter": lead["seconds"] * 1e3 / max(lead["iters"], 1),
                      "seconds": lead["seconds"], "gteps": lead["gteps"],
                      "split": lead.get("exchange"), "launches": launches, "held": held,
                      "plans": [r["plans"] for r in per_rank],
                      "wall_s": [r["wall_s"] for r in per_rank],
                      "rank_devices": [r["device"] for r in res], "device": smi})
                continue
            if kind == "run":
                err = dist_workload_check(np, label, per_rank, spec_ref, 1 << SCALE)
                emit({"phase": "dist", "run": label, "group": name, "backend": backend,
                      "ranks": world, "argv": argv, **err,
                      "ms_per_iter": lead["seconds"] * 1e3 / max(lead["iters"], 1),
                      "seconds": lead["seconds"], "gteps": lead["gteps"],
                      "launches": launches, "wall_s": [r["wall_s"] for r in per_rank],
                      "rank_devices": [r["device"] for r in res], "device": smi})
                continue
            if kind in ("sssp", "components"):
                err = dist_push_check(np, label, kind, argv, per_rank, push_want[label])
                require(label != "push-repart" or lead["recuts"] > 0,
                        "dist push-repart: --repartition-every 1 made no recut")
                held = [r["held"] for r in per_rank if "held" in r]
                rows += held
                emit({"phase": "dist", "run": label, "group": name, "backend": backend,
                      "ranks": world, "app": kind, "argv": argv, **err,
                      "ms_per_iter": lead["seconds"] * 1e3 / max(lead["iters"], 1),
                      "seconds": lead["seconds"], "gteps": lead["gteps"],
                      "recuts": lead["recuts"], "split": lead.get("exchange"),
                      "launches": launches, "held": held,
                      "wall_s": [r["wall_s"] for r in per_rank],
                      "rank_devices": [r["device"] for r in res], "device": smi})
                continue
            state = lead["state"]
            require(state is not None and bool(np.isfinite(state).all()),
                    f"dist {label}: no finite state on rank 0")
            if label.startswith("allgather"):
                exact = bool(np.array_equal(state, want_default))
                require(exact, f"dist {label}: ranks differ from the single-process -ng 8 run")
                err = {"bitwise_single_process": exact}
            elif kind == "pagerank":
                rel = float(np.max(np.abs(state.astype(np.float64) - pr64) / np.abs(pr64)))
                require(rel <= RANK_RTOL, f"dist {label}: off the float64 oracle by {rel}")
                err = {"max_rel_err_vs_f64": rel}
            elif kind == "pallas":
                rel = float(np.max(np.abs(state.astype(np.float64) - pr_ref20)
                                   / np.abs(pr_ref20.astype(np.float64))))
                require(rel <= RANK_RTOL, f"dist {label}: off the float64 oracle by {rel}")
                err = {"max_rel_err_vs_f64": rel}
            elif kind == "edge2d":
                rel = float(np.max(np.abs(state.astype(np.float64) - pr_ref20)
                                   / np.abs(pr_ref20.astype(np.float64))))
                require(rel <= RANK_RTOL, f"dist {label}: off the float64 oracle by {rel}")
                err = {"max_rel_err_vs_f64": rel}
            elif kind == "feat":
                require(state.shape == v64.shape, f"dist {label}: state {state.shape}, "
                                                  f"the oracle's {v64.shape}")
                rel = float(np.max(np.abs(state - v64) / np.abs(v64)))
                require(rel <= CF_RTOL, f"dist {label}: off the float64 oracle by {rel}")
                err = {"max_rel_err_vs_f64": rel, "gamma": CF_GAMMA}
            elif kind == "cf-app":
                rel = float(np.max(np.abs(state - cf_pallas20) / np.abs(cf_pallas20)))
                require(rel <= CF_RTOL, f"dist {label}: off the single-process pallas run "
                                        f"by {rel}")
                err = {"max_rel_err_vs_single_process": rel,
                       "max_abs_err_vs_single_process": float(np.max(np.abs(
                           state - cf_pallas20)))}
            else:
                rel = float(np.max(np.abs(state - v64) / np.abs(v64)))
                require(rel <= CF_RTOL, f"dist {label}: off the float64 oracle by {rel}")
                err = {"max_rel_err_vs_f64": rel}
            require(all(r["rc"] == 0 for r in per_rank), f"dist {label}: a rank's -check failed")
            kernel = DIST_KERNEL.get(kind if kind != "pagerank" else
                                     ("allgather" if label.startswith("allgather") else label))
            if kernel:
                need = ITERS * (DISK_PARTS // world if kind == "pagerank" else 1)
                require(all(c[kernel] >= need for c in launches),
                        f"dist {label}: {kernel} launched {[c[kernel] for c in launches]} "
                        f"times in the ranks (need {need} each)")
            held = [r["held"] for r in per_rank if "held" in r]
            rows += held
            emit({"phase": "dist", "run": label, "group": name, "backend": backend,
                  "ranks": world, "argv": argv, **err,
                  "ms_per_iter": lead["seconds"] * 1e3 / ITERS, "gteps": lead["gteps"],
                  "split": lead.get("exchange"), "launches": launches, "held": held,
                  "wall_s": [r["wall_s"] for r in per_rank],
                  "rank_devices": [r["device"] for r in res], "device": smi})
        emit({"phase": "dist", "group": name, "backend": backend, "ranks": world,
              "seconds": time.perf_counter() - t0})
    left = [c for pid, c in child_processes()
            if pid not in before and "resource_tracker" not in c]
    require(not left, f"dist: rank processes left behind: {left}")
    emit({"phase": "dist", "launches": total, "routed_plans": routed_plans,
          "seconds": time.perf_counter() - t_phase})
    return total, rows


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the card",
              file=sys.stderr)
        return 2
    t_smoke = time.perf_counter()
    from lux_tpu_torch import native
    from lux_tpu_torch.apps import colfilter as cf_app
    from lux_tpu_torch.apps import common
    from lux_tpu_torch.apps import components as cc_app
    from lux_tpu_torch.apps import pagerank as app
    from lux_tpu_torch.apps import sssp as sssp_app
    from lux_tpu_torch.engine import push
    from lux_tpu_torch.graph import csc, generate
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.models import colfilter as cf_model
    from lux_tpu_torch.models import components as cc_model
    from lux_tpu_torch.models import sssp as sssp_model
    from lux_tpu_torch.models.pagerank import pagerank_reference
    from lux_tpu_torch.native import io as native_io
    from lux_tpu_torch.ops import cuda_build, expand, scan, segment, shuffle, spmv
    from lux_tpu_torch.ops import route as route_mod
    from lux_tpu_torch.tools import kernel_timing
    from lux_tpu_torch.utils.config import parse_args

    share_push_layouts(sssp_app)
    # the host oracles take minutes: those of phase 4's window start now, beside
    # the card; the rest after phase 7
    global _POOL, _TMP
    _TMP = tempfile.mkdtemp(prefix="lux_smoke_")
    # one flight-recorder run for the whole smoke: this process, the pool
    # and the apps it spawns write their event logs into one run directory
    from lux_tpu_torch import obs
    os.environ["LUX_OBS_DIR"] = os.path.join(_TMP, "obs")
    os.environ["LUX_OBS_RUN_ID"] = obs.new_run_id()
    os.environ.pop("LUX_OBS", None)
    _POOL = concurrent.futures.ProcessPoolExecutor(
        4, mp_context=multiprocessing.get_context("spawn"))
    push_oracle = _POOL.submit(push_oracles, SCALE)
    spec_oracle_a = _POOL.submit(spec_oracles_bfs_labelprop, SCALE)
    spec_oracle_b = _POOL.submit(spec_oracles_kcore_triangles, SCALE, TRI_SCALE)
    serve_oracle = _POOL.submit(serve_oracles, SCALE)  # early: phase 17 opens phase 4's window
    long_w = _POOL.submit(long_weighted_graph, _TMP, SCALE)
    plan_dir = os.path.join(_TMP, "main_plans")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    kernels = counters()

    # 1. device
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "numpy": np.__version__, "host": host_line(_TMP)})

    # 2. build: nvcc of the kernels; beside it g++ of the native host I/O
    # library and lux-convert (a thread: the compilers are processes)
    t0 = time.perf_counter()
    io_build = {}

    def build_io():
        t = time.perf_counter()
        io_build["ok"] = native_io.available() and native_io.converter() is not None
        io_build["seconds"] = time.perf_counter() - t

    io_thread = threading.Thread(target=build_io)
    io_thread.start()
    built = cuda_build.build_all()
    t1 = time.perf_counter()
    require(native.available(), "the native route colorer did not build")
    t2 = time.perf_counter()
    io_thread.join()
    require(io_build.get("ok", False), "the native host I/O library or lux-convert did not build")
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": built,
          "nvcc_wall": t1 - t0, "native_colorer_seconds": t2 - t1,
          "native_io_seconds": io_build["seconds"], "nvcc": cuda_build.nvcc_path(),
          "native": str(native.library_path().name),
          "native_io": str(native_io.library_path().name)})
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name}: {line.strip()}", flush=True)

    # 3. kernels of the direct path against their plain versions
    t0 = time.perf_counter()
    small = ragged_graph(np, csc)
    small_bc = spmv.build_blockcsr(small)
    g = generate.rmat(SCALE, EF, seed=0)
    bc = spmv.build_blockcsr(g)
    require(bc.host_io == "native", f"kernels: the block-CSR was filled by {bc.host_io}")
    rows_spmv = (spmv_cases(torch, np, spmv, small_bc, dev, REPS, False)
                 + spmv_cases(torch, np, spmv, bc, dev, REPS, True))
    rng = np.random.default_rng(9)
    n_small = 10007
    head_s = rng.random(n_small) < 0.1
    head_s[3000:9000] = False  # one segment spanning several tiles
    vals_s = rng.random(n_small, dtype=np.float32) + 0.01
    vals_s[9500:] = np.where(np.arange(n_small - 9500) % 2, np.nan, np.inf)
    invalid_s = np.zeros(n_small, bool)
    invalid_s[9500:] = True
    rows_scan = scan_cases(
        torch, np, scan, torch.from_numpy(head_s).to(dev), None,
        torch.from_numpy(invalid_s).to(dev), torch.from_numpy(vals_s).to(dev),
        dev, REPS, False)
    sh = build_pull_shards(g, 1)
    state = torch.from_numpy(rng.random(sh.spec.gathered_size, dtype=np.float32)
                             + 0.01).to(dev)
    src_pos = torch.from_numpy(sh.arrays.src_pos[0]).to(dev).long()
    row_ptr = torch.from_numpy(sh.arrays.row_ptr[0]).to(dev)
    main_head = torch.from_numpy(sh.arrays.head_flag[0]).to(dev)
    main_vals = state[src_pos].contiguous()
    rows_scan += scan_cases(torch, np, scan, main_head, row_ptr[-1:], None, main_vals, dev,
                            REPS, True)
    spmv_main, scan_main = timed(rows_spmv), timed(rows_scan)
    spmv_hub = spmv_hub_case(torch, np, spmv, bc, dev, REPS, spmv_main["kernel_ms"])
    scan_seg = scan_one_segment_case(torch, np, scan, dev, REPS, scan_main["kernel_ms"])
    # the launches: grid, threads, shared-memory bytes (static: the
    # combination trees' per-warp tables; no dynamic shared memory)
    C, T = bc.e_dst_rel.shape
    n_out = bc.num_vblocks * bc.v_blk
    e_dst = torch.from_numpy(bc.e_dst_rel).to(dev)
    cb = torch.from_numpy(bc.chunk_block).to(dev)
    cf = torch.from_numpy(bc.chunk_first).to(dev)
    spmv_vals = state[torch.from_numpy(bc.e_src_pos).to(dev).long()]
    spmv_launch = {
        "fill": {"ctas": min(-(-n_out // 256), 1056), "threads": 256, "smem_bytes": 0},
        "spans": {"ctas": -(-C * T // spmv.SPAN_SLOTS), "threads": 512,
                  "slots_per_cta": spmv.SPAN_SLOTS, "smem_bytes": 5 * 32 * 4},
        "fold": {"ctas": 1, "threads": 1024, "smem_bytes": 5 * 32 * 4}}
    n_scan = main_vals.numel()
    tiles = -(-n_scan // 8192)
    scan_launch = {
        "tiles": {"ctas": tiles, "threads": 512, "elems_per_cta": 8192,
                  "smem_bytes": 3 * 16 * 4},
        "carries": {"ctas": 1, "threads": 1024, "smem_bytes": 2 * 32 * 4},
        "apply": {"ctas": tiles - 1, "threads": 256, "smem_bytes": 0}}
    # the main shapes' f32 sums, traced with the mx kernel in phase 5
    to_trace = {
        "spmv_blockcsr": (functools.partial(
            spmv.spmv_blockcsr, spmv_vals, e_dst, cb, cf, op="sum", v_blk=bc.v_blk,
            num_vblocks=bc.num_vblocks), {"fill": "runs_fill_kernel", "spans": "spmv_span_kernel",
                                          "fold": "runs_fold_kernel"}),
        "mxscan_segmented": (functools.partial(
            scan.mxscan_segmented, main_vals, main_head, op="sum", valid_end=row_ptr[-1:]),
            {"tiles": "scan_tiles", "carries": "scan_carries", "apply": "apply_carries"})}
    emit({"phase": "kernels", "kernels": ["spmv_blockcsr", "mxscan_segmented"],
          "spmv_blockcsr": rows_spmv, "mxscan_segmented": rows_scan,
          "spmv_one_hub": spmv_hub, "scan_one_segment": scan_seg,
          "spmv_launch": spmv_launch, "scan_launch": scan_launch,
          "graph": {"scale": SCALE, "ef": EF, "nv": g.nv, "ne": g.ne,
                    "chunks": C, "t_chunk": T, "vblocks": bc.num_vblocks},
          "seconds": time.perf_counter() - t0})
    del bc, state, src_pos, row_ptr, main_head, main_vals, spmv_vals, e_dst, cb, cf

    # 4. the routed plans, each family built once, through the cached
    # planners the apps call, into a cache directory that phase 19 loads
    # again.  The three chains, the live phase's post-compaction base, the
    # sorted layout's plan and the weighted "min" plan build at once, each
    # in a process of its own (threads of one process serialize on the
    # interpreter lock); each -pf upgrade after the plan it upgrades, from
    # the cache.  The card does not wait for them: phases 17 and 9-14,
    # which need no routed plan of the main graph but the expand chain's
    # (loaded once that chain is in the cache), run here beside the
    # builds, so their host clocks are taken under that load; the kernel
    # table's timings (phases 3, 5, 7 and 13b) and the CF runs (whose host
    # work slows 2-3x under it) stay outside.  A family's seconds are its
    # wall time beside the others
    t_plan = time.perf_counter()
    save_graph(np, _TMP, "main", g)
    plan_pool = concurrent.futures.ProcessPoolExecutor(
        len(PLAN_CHAINS) + 3, mp_context=multiprocessing.get_context("spawn"))
    # the routed legs' plans (phase 25): a pool of their own, waited for at phase 25
    dist_plan_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    dist_plan_fut = dist_plan_pool.submit(dist_plans, _TMP, plan_dir)
    variants_plan_fut = plan_pool.submit(variants_plan, plan_dir)
    live_plan_fut = plan_pool.submit(live_plan, _TMP, plan_dir)
    sorted_plan_fut = plan_pool.submit(sorted_plan, _TMP, plan_dir)
    chain_futs = [plan_pool.submit(plan_chain, _TMP, plan_dir, chain) for chain in PLAN_CHAINS]

    # 17. the batched query service (no routed plan), while the expand chain builds
    serve_launches, served = serve_main(torch, np, kernels, smi, dev, g, sh, serve_oracle)
    torch.cuda.empty_cache()

    # the expand chain's plans, which the push, spec and delta phases replay
    chain_futs[0].result()
    push_plans = {m: plan_family(sh, m, plan_dir) for m in PLAN_CHAINS[0]}

    # 9. SSSP through the app from the vertex with the largest out-degree
    t0 = time.perf_counter()
    start = int(np.argmax(g.out_degrees()))
    sssp_runs, sssp_launches = push_runs(np, sssp_app, "push_main", g, ["-start", str(start)],
                                         push_plans, kernels, smi)
    o_start, o_dist, o_labels, oracle_s, o_tail = push_oracle.result(timeout=900)
    require(o_start == start, f"the oracle's start {o_start} is not {start}")
    require(np.array_equal(sssp_runs["mxscan"].state, o_dist),
            "SSSP distances differ from the scipy BFS oracle")
    emit({"phase": "push_main", "start": start, "oracle": "scipy.sparse.csgraph BFS",
          "oracle_seconds": oracle_s, "reached": int((o_dist < g.nv).sum()),
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    # 10. connected components: the push form under the five modes, the pull form once
    t0 = time.perf_counter()
    cc_runs, cc_launches = push_runs(np, cc_app, "cc_main", g, [], push_plans, kernels, smi)
    for fn in kernels.values():
        fn.launches = 0
    t1 = time.perf_counter()
    pull_labels = cc_model.connected_components(g, method="mxscan", device=dev)
    pull_s = time.perf_counter() - t1
    pull_counts = {name: fn.launches for name, fn in kernels.items()}
    require(pull_counts["mxscan_segmented"] > 0, "the pull form launched no mxscan")
    require(np.array_equal(pull_labels, cc_runs["mxscan"].state),
            "the pull form's labels differ from the push form's")
    require(np.array_equal(cc_runs["mxscan"].state, o_labels),
            "labels differ from the max-label fixpoint oracle")
    emit({"phase": "cc_main", "run": "pull", "method": "mxscan", "wall_seconds": pull_s,
          "launches": pull_counts, "distinct_labels": int(len(np.unique(o_labels))),
          "oracle": "max-label fixpoint (np.maximum.at)", "seconds": time.perf_counter() - t0})
    race = push_race(torch, push, sh, (
        ("sssp", sssp_model.SSSPProgram(nv=g.nv, start=start), sssp_runs["mxscan"].state),
        ("components", cc_model.MaxLabelProgram(), cc_runs["mxscan"].state)), dev, REPS)
    emit({"phase": "push_race", "ms_per_dense_round": race,
          "winner": {name: min(ms, key=ms.get) for name, ms in race.items()}, "device": smi})
    cc_whole = cc_runs["mxscan"]  # phase 16's uninterrupted run
    # phase dist's push runs must equal these bitwise
    push_ref = {app: {"state": r["mxscan"].state, "iters": r["mxscan"].iters,
                      "traversed": r["mxscan"].traversed, "start": start}
                for app, r in (("sssp", sssp_runs), ("components", cc_runs))}
    del sssp_runs, cc_runs
    torch.cuda.empty_cache()

    # 11-12. the spec workloads, their kernel callers, the sum race
    spec_launches, spec_ref = spec_phases(torch, np, g, sh, push_plans, kernels, smi, dev,
                                          spec_oracle_a, spec_oracle_b)
    torch.cuda.empty_cache()

    # 13-14. the long runs: delta-stepping and adaptive repartitioning
    long_launches = {}
    gw, delta_runs, long_launches["delta"], delta_row = delta_main(
        torch, np, kernels, smi, dev, _TMP, long_w, push_plans["expand-pf"], start, REPS)
    d0 = delta_runs[f"delta-{DIST_DELTA}"]
    push_ref["delta"] = {"state": d0.state, "iters": d0.iters, "traversed": d0.traversed,
                         "start": start}
    del d0
    torch.cuda.empty_cache()
    long_launches["repart"], push_ref["tail"] = repart_main(np, kernels, smi, g, o_tail,
                                                            o_labels)
    push_ref["tail"]["state"] = o_tail
    torch.cuda.empty_cache()

    # 4 (end): every plan family built; this process loads the rest of the
    # main graph's from the cache
    t1 = time.perf_counter()
    built = [f.result() for f in chain_futs]
    live_plan_row = live_plan_fut.result()
    sorted_plan_row = sorted_plan_fut.result()
    variants_plan_row = variants_plan_fut.result()
    plan_pool.shutdown()
    reports = [rep for reps, _ in built for rep in reps]
    calls = {k: sum(c.get(k, 0) for _, c in built) for k in ("native", "numpy")}
    t2 = time.perf_counter()
    plans = push_plans  # and the other families of the main graph
    del push_plans
    plans.update({mode: plan_family(sh, mode, plan_dir)
                  for chain in PLAN_CHAINS for mode in chain if mode not in plans})
    emit({"phase": "plan", "plans": reports, "cache_dir": plan_dir,
          "parallel_chains": len(PLAN_CHAINS), "colorer_calls": calls,
          "live_compaction_base": live_plan_row, "sorted_fused_pf": sorted_plan_row,
          "weighted_fused_mx_min": variants_plan_row, "wait_seconds": t2 - t1,
          "load_seconds": time.perf_counter() - t2, "seconds": time.perf_counter() - t_plan})
    require(calls["native"] > 0 and calls["numpy"] == 0,
            f"plan: colorer {calls}, the native one must run for every family")
    built_s = {r["mode"]: r["seconds"] for r in reports}

    # 5. the routed-pull kernels against their plain versions
    t0 = time.perf_counter()
    on_dev = {m: expand.plan_to_device(p, dev) for m, p in plans.items()}
    r1a = expand.split_arrays(on_dev["expand"][0], on_dev["expand"][1])[0]
    rows_lane = lane_cases(torch, np, shuffle, dev, r1a[0][0].reshape(-1, 128), REPS)
    rows_sub = sublane_cases(torch, np, shuffle, dev, REPS)
    part = {m: (st, tuple(a[0] for a in arr)) for m, (st, arr) in on_dev.items()}
    rows_fused = fused_cases(torch, np, shuffle, expand, part["expand-pf"], dev, REPS)
    rows_mx, mx_fn = mx_cases(torch, np, shuffle, expand, part["fused-mx"], dev, REPS)
    to_trace["mxreduce_pass_gather"] = (mx_fn, {"fill": "runs_fill_kernel",
                                                "chunks": "mx_chunk_kernel",
                                                "fold": "runs_fold_kernel"})
    yard = path_yardsticks(torch, np, expand, segment, sh, on_dev, dev, REPS)
    # each launch's traced device time, the three kernels in one session
    traced = traced_splits(torch, to_trace)
    del to_trace, mx_fn
    emit({"phase": "routed", "lane_gather": rows_lane, "sublane_gather": rows_sub,
          "fused_pass_gather": rows_fused, "mxreduce_pass_gather": rows_mx,
          "path": yard, "seconds": time.perf_counter() - t0})
    mx_t = traced["mxreduce_pass_gather"]
    mx_total = sum(ms for ms in mx_t.values() if ms)
    emit({"phase": "traced", "traced_ms": traced,
          "mx_fold_share": mx_t["fold"] / mx_total if mx_t["fold"] else None})
    del on_dev, part, r1a
    torch.cuda.empty_cache()

    # 6. the main path, through the app
    ref = None
    runs, launches, ranks = [], {}, {}
    runs = [("pallas", ["--method", "pallas"], None), ("mxscan", ["--method", "mxscan"], None)]
    for mode in ROUTED:
        flag = ["--route-gather"] + ([mode] if mode else [])
        method = ["--method", "mxscan"] if not mode.startswith("fused") else []
        runs.append((mode or "bare", flag + method, plans[mode or "expand-pf"]))
    for label, extra, route in runs:
        argv_app = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0",
                    "-ni", str(ITERS), "-check", "--device", "cuda"] + extra
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = app.run(argv_app, route=route, graph=g)
        counts = {name: fn.launches for name, fn in kernels.items()}
        mode = res.route_gather or label
        launches[mode] = counts
        ranks[mode] = res.ranks
        if ref is None:
            ref = pagerank_reference(res.graph, ITERS)
        finite = bool(np.isfinite(res.ranks).all()) and res.ranks.shape == (res.graph.nv,)
        rel = float(np.max(np.abs(res.ranks.astype(np.float64) - ref)
                           / np.abs(ref.astype(np.float64))))
        emit({"phase": "main", "run": label, "mode": mode, "argv": extra, "rc": res.rc,
              "launches": counts, "finite": finite, "max_rel_err_vs_f64": rel,
              "gteps": res.gteps, "ms_per_iter": res.seconds * 1e3 / ITERS,
              "seconds": res.seconds, "wall_seconds": time.perf_counter() - t0,
              "nv": res.graph.nv, "ne": res.graph.ne, "device": smi})
        require(res.rc == 0, f"{label}: -check failed")
        require(finite, f"{label}: ranks not finite or misshaped")
        require(rel <= RANK_RTOL, f"{label}: ranks off the f64 oracle by {rel}")
        require(counts[RUN_KERNEL[mode]] >= ITERS,
                f"{label}: {RUN_KERNEL[mode]} launched {counts[RUN_KERNEL[mode]]} times")
        if mode.startswith("expand"):
            require(counts["mxscan_segmented"] >= ITERS, f"{label}: mxscan not launched")
            require(np.array_equal(res.ranks, ranks["mxscan"]),
                    f"{label}: ranks differ from the direct mxscan run")
        if label == "bare":
            require(mode == "expand-pf", f"the bare --route-gather ran {mode}")
    require(np.array_equal(ranks["fused-pf"], ranks["fused"]),
            "fused-pf ranks differ from fused")
    # the dynamic-graph phase reuses the pass-fused families
    mutate_plans = {m: plans[m] for m in ("expand-pf", "fused-pf", "fused-mx")}
    pr_ranks = ranks["mxscan"]  # phase 16's uninterrupted run
    main_pf = (ranks["expand-pf"], launches["expand-pf"])  # phase 19's cold runs
    pr_ref20 = ref  # phase dist's pallas run
    del plans, ranks, ref, res, small, small_bc
    torch.cuda.empty_cache()

    # 13b. the bf16 and weighted-edge forms, and weighted SSSP on fused-mx
    variant_rows, variants_launches, _ = variants_main(
        torch, np, kernels, smi, dev, g, sh, gw, delta_runs["chaotic"].state, start, plan_dir,
        mutate_plans["fused-mx"], REPS)
    torch.cuda.empty_cache()

    # 7. collaborative filtering's kernel against its plain version
    t0 = time.perf_counter()
    g_cf = common.load_graph(parse_args(cf_argv(SCALE)), weighted=True, bipartite=True)
    save_graph(np, _TMP, "cf", g_cf)  # phase dist's ranks load it
    bc_cf = spmv.build_blockcsr(g_cf)
    rows_2d = (spmv_2d_cases(torch, np, spmv, spmv.build_blockcsr(ragged_graph(np, csc)), dev,
                             (1, 3, CF_K), REPS, False)
               + spmv_2d_cases(torch, np, spmv, bc_cf, dev, (CF_K,), REPS, True))
    emit({"phase": "cf_kernel", "spmv_blockcsr_2d": rows_2d,
          "graph": {"scale": SCALE, "ef": EF, "nv": g_cf.nv, "ne": g_cf.ne,
                    "chunks": bc_cf.num_chunks, "vblocks": bc_cf.num_vblocks},
          "seconds": time.perf_counter() - t0})
    del bc_cf
    torch.cuda.empty_cache()

    # 7b. the scatter method's deterministic float sum: the sorted-key kernel
    # at RMAT 20's (E,), CF 20's (E, K) and serving's (E, Q) on the main layout
    t0 = time.perf_counter()
    sh_cf = build_pull_shards(g_cf, 1)
    main_keys = torch.from_numpy(sh.arrays.dst_local[0]).to(dev)
    rows_sum = segsum_cases(torch, kernel_timing, (
        (f"rmat{SCALE} (E,)", main_keys, sh.spec.nv_pad, 1),
        (f"cf{SCALE} (E, {CF_K})", torch.from_numpy(sh_cf.arrays.dst_local[0]).to(dev),
         sh_cf.spec.nv_pad, CF_K),
        (f"serve (E, {SERVE_Q})", main_keys, sh.spec.nv_pad, SERVE_Q)), dev)
    emit({"phase": "segsum", "segment_sum_sorted": rows_sum,
          "seconds": time.perf_counter() - t0})
    del sh_cf, main_keys
    torch.cuda.empty_cache()

    # the oracles that only the later phases read start here, after phase
    # 4 and the kernel timings of phases 5, 13b and 7: from here on the
    # host's cores are mostly idle beside the card
    cf_oracle = _POOL.submit(cf_oracle_f64, SCALE)
    long_s = _POOL.submit(long_stream_graph, _TMP, STREAM_SCALE)
    mutate_oracle = _POOL.submit(mutate_oracles, SCALE)
    live_oracle = _POOL.submit(live_oracles, SCALE)

    # 8. collaborative filtering through the app: the kernel path and the
    # engine at scale 20, the routed reads at CF_ROUTED_SCALE
    t0 = time.perf_counter()
    g_r = common.load_graph(parse_args(cf_argv(CF_ROUTED_SCALE)), weighted=True,
                            bipartite=True)
    sh_r = build_pull_shards(g_r, 1)
    route_mod.reset_color_stats()
    plan_e = expand.plan_cf_route_shards(sh_r)
    t1 = time.perf_counter()
    plan_pf = expand.to_pf(plan_e)
    emit({"phase": "cf_plan", "scale": CF_ROUTED_SCALE, "nv": g_r.nv, "ne": g_r.ne,
          "expand_seconds": t1 - t0, "to_pf_seconds": time.perf_counter() - t1,
          "arrays": len(plan_e[1]), "pf_arrays": len(plan_pf[1]),
          "colorer_calls": dict(route_mod.COLOR_STATS)})
    del sh_r
    states = {}
    for scale, label, extra, route in (
            (SCALE, "pallas", ["--method", "pallas"], None),
            (SCALE, "scatter", ["--method", "scatter"], None),
            (CF_ROUTED_SCALE, "direct", [], None),
            (CF_ROUTED_SCALE, "expand-pf", ["--route-gather", "expand-pf"], plan_pf),
            (CF_ROUTED_SCALE, "expand", ["--route-gather", "expand"], plan_e)):
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = cf_app.run(cf_argv(scale) + extra, route=route,
                         graph=g_cf if scale == SCALE else g_r)
        counts = {name: fn.launches for name, fn in kernels.items()}
        launches[f"cf-{label}"] = counts
        states[label] = res.state
        finite = (bool(np.isfinite(res.state).all())
                  and res.state.shape == (res.graph.nv, CF_K))
        emit({"phase": "cf_main", "run": label, "scale": scale, "argv": extra, "rc": res.rc,
              "launches": counts, "finite": finite, "rmse": res.rmse,
              "rmse_init": cf_model.init_rmse(res.graph), "gteps": res.gteps,
              "ms_per_iter": res.seconds * 1e3 / ITERS, "seconds": res.seconds,
              "wall_seconds": time.perf_counter() - t0, "nv": res.graph.nv,
              "ne": res.graph.ne, "device": smi})
        require(res.rc == 0, f"cf {label}: -check failed")
        require(finite, f"cf {label}: state not finite or misshaped")
        if label in CF_RUN_KERNEL:
            name = CF_RUN_KERNEL[label]
            require(counts[name] >= ITERS, f"cf {label}: {name} launched {counts[name]} times")
        if route is not None:
            require(np.array_equal(res.state, states["direct"]),
                    f"cf {label}: state differs from the direct run at scale {scale}")
        del res
    cf_pallas20 = states["pallas"]  # phase dist's CF app run
    del plan_e, plan_pf, states, g_r
    torch.cuda.empty_cache()

    # 16. the checkpointed runs
    long_launches["ckpt"] = ckpt_main(np, kernels, smi, _TMP, g, gw, start, pr_ranks,
                                      delta_runs[f"delta-{DELTA_WIDTHS[0]}"], cc_whole)
    del gw, delta_runs, cc_whole, pr_ranks
    torch.cuda.empty_cache()

    # 18. dynamic graphs
    mutate_launches, mutate_err, mutate_out = mutate_main(
        torch, np, kernels, smi, dev, g, _TMP, mutate_oracle, (g, sh, mutate_plans), REPS)
    del mutate_plans
    torch.cuda.empty_cache()

    # 19. cold start and observability
    # the main graph's .lux snapshot: the --profile-dir subprocess here and
    # the fleet, pod and live workers read it (phases 20-22)
    from lux_tpu_torch.graph.format import write_lux

    snap = os.path.join(_TMP, "fleet_main.lux")
    write_lux(snap, g)
    cold_launches = cold_obs_main(torch, np, kernels, smi, dev, g, sh, plan_dir, main_pf,
                                  built_s, launches["pallas"], snap)
    del sh, main_pf
    torch.cuda.empty_cache()

    # 8 (end). the libraries at gamma = CF_GAMMA against the f64 oracle (started
    # after phase 7)
    t0 = time.perf_counter()
    run_2d, s0 = cf_model.make_pallas_runner(g_cf, gamma=CF_GAMMA, device=dev)
    got = {"make_pallas_runner": run_2d(s0, ITERS)[: g_cf.nv].float().cpu().numpy()}
    del run_2d, s0
    torch.cuda.empty_cache()
    got["colfilter"] = cf_model.colfilter(g_cf, ITERS, gamma=CF_GAMMA, device=dev)
    t1 = time.perf_counter()
    v64, rmse64, oracle_s = cf_oracle.result(timeout=1200)
    for name, v in got.items():
        rel = float(np.max(np.abs(v - v64) / np.abs(v64)))
        rmse = cf_model.rmse(g_cf, v)
        emit({"phase": "cf_accuracy", "runner": name, "gamma": CF_GAMMA, "iters": ITERS,
              "max_rel_err_vs_f64": rel, "rmse": rmse, "rmse_init": cf_model.init_rmse(g_cf),
              "oracle_rmse": rmse64, "oracle_seconds": oracle_s,
              "oracle_wait_seconds": time.perf_counter() - t1,
              "runs_seconds": t1 - t0})
        require(bool(np.isfinite(v).all()) and v.shape == (g_cf.nv, CF_K),
                f"{name}: state not finite or misshaped")
        require(rel <= CF_RTOL, f"{name}: off the f64 oracle by {rel}")
        require(rmse < cf_model.init_rmse(g_cf), f"{name}: training did not lower the RMSE")

    del g_cf, got
    torch.cuda.empty_cache()

    # 15. the streamed runs (their oracle started after phase 7)
    long_launches["stream"], stream_rows = stream_main(torch, np, kernels, smi, dev, _TMP,
                                                       long_s, REPS)
    long_rows = [delta_row] + stream_rows
    torch.cuda.empty_cache()

    # 20-21. the serving fleet and a pod: worker processes on the card
    fleet_launches, fleet_rows = fleet_main(torch, np, kernels, smi, dev, snap, served,
                                            mutate_out["churn_snapshot"])
    live_sources = served[0]
    del served
    pod_launches, pod_rows = pod_main(torch, np, kernels, smi, dev, g, snap, start)
    fleet_launches = {k: fleet_launches[k] + pod_launches[k] for k in kernels}
    require(fleet_launches["mxscan_segmented"] > 0, "the fleet path launched no mxscan")
    require(all(n == 0 for k, n in fleet_launches.items() if k != "mxscan_segmented"),
            f"the fleet path launched kernels it does not run: {fleet_launches}")
    torch.cuda.empty_cache()

    # 22-23. live serving and the autopilot: worker processes on the card
    emit({"phase": "live", "run": "plan", "compaction_base": live_plan_row})
    require(live_plan_row["sha"] == live_oracle.result(timeout=1200)["base_sha"],
            "live: the planned compaction base is not the pool's")
    live_launches, live_err = live_main(torch, np, kernels, smi, dev, g, snap, start, plan_dir,
                                        live_oracle, live_sources, REPS)
    torch.cuda.empty_cache()
    pilot_launches = autopilot_main(torch, np, kernels, smi, dev, snap,
                                    fleet_rows["saturation"][1]["knee_qps"])
    torch.cuda.empty_cache()
    left = launch_dirs()
    require(not left, f"launcher directories left behind: {left}")

    # 24. big graphs from disk
    disk_launches, disk_rows, disk = disk_main(torch, np, kernels, smi, dev, _TMP, g, start,
                                               o_dist, o_labels, long_s, plan_dir, REPS)
    del g
    torch.cuda.empty_cache()

    # 25. the distributed pull engine: ranks that share the card
    routed_plans = dist_plan_fut.result()
    dist_plan_pool.shutdown()
    dist_launches, dist_rows = dist_main(torch, np, kernels, smi, _TMP, disk, pr_ref20,
                                         cf_pallas20, v64, push_ref, spec_ref, plan_dir,
                                         routed_plans)
    del disk, pr_ref20, cf_pallas20, v64, push_ref, spec_ref
    obs_log_main(smi)

    table = []
    for name, rows, stress, run, replaces in (
            ("spmv_blockcsr", rows_spmv, spmv_hub, "pallas", "lux_tpu/ops/pallas_spmv.py:273"),
            ("mxscan_segmented", rows_scan, scan_seg, "mxscan",
             "lux_tpu/ops/pallas_scan.py:193")):
        r = timed(rows)
        extra = long_rows + pod_rows + disk_rows if name == "mxscan_segmented" else []
        table.append({"name": name, "route": "cuda",
                      "source": f"lux_tpu_torch/csrc/{cuda_build.SOURCES[name]}",
                      "replaces": replaces, "launches": launches[run][name],
                      "max_abs_err": max(x["max_abs_err"] for x in rows + [stress] + extra),
                      "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound_ms"], "bound_by": "bytes",
                      "library_ms": r["library_ms"]})
    r = next(x for x in rows_2d if "kernel_ms" in x and x["dtype"] == "float32")
    table.append({"name": "spmv_blockcsr_2d", "route": "cuda",
                  "source": f"lux_tpu_torch/csrc/{cuda_build.SOURCES['spmv_blockcsr_2d']}",
                  "replaces": "lux_tpu/ops/pallas_spmv.py:343",
                  "launches": launches["cf-pallas"]["spmv_blockcsr_2d"],
                  "max_abs_err": max(x["max_abs_err"] for x in rows_2d),
                  "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                  "bound_by": "bytes", "library_ms": r["library_ms"]})
    for name, r, replaces in (
            ("lane_gather", rows_lane, "lux_tpu/ops/pallas_shuffle.py:89"),
            ("sublane_gather", rows_sub, "lux_tpu/ops/pallas_shuffle.py:116"),
            ("fused_pass_gather", rows_fused, "lux_tpu/ops/pallas_shuffle.py:981"),
            ("mxreduce_pass_gather", rows_mx, "lux_tpu/ops/pallas_shuffle.py:937")):
        table.append({"name": name, "route": "cuda",
                      "source": f"lux_tpu_torch/csrc/{cuda_build.SOURCES[name]}",
                      "replaces": replaces,
                      "launches": max(c[name] for c in launches.values()),
                      "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": "bytes", "library_ms": r["library_ms"]})
    r = rows_sum[0]
    table.append({"name": "segment_sum_sorted", "route": "cuda",
                  "source": f"lux_tpu_torch/csrc/{cuda_build.SOURCES['segment_sum_sorted']}",
                  "replaces": "none: XLA's sorted segment_sum, lux_tpu/ops/segment.py:172",
                  "launches": launches["cf-scatter"]["segment_sum_sorted"],
                  "max_abs_err": max(x["max_abs_err"] for x in rows_sum),
                  "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                  "bound_by": "bytes", "library_ms": r["library_ms"],
                  "shapes": [{k: x[k] for k in ("case", "shape", "kernel_ms", "library_ms",
                                                "bound_ms", "bitwise_rerun")}
                             for x in rows_sum]})
    for row in table:
        run = PUSH_KERNEL_RUN.get(row["name"])
        row["launches_push"] = {"sssp": sssp_launches[run][row["name"]] if run else 0,
                                "components": cc_launches[run][row["name"]] if run else 0}
        row["launches_spec"] = {
            prog: spec_launches[runs[row["name"]]][row["name"]] if row["name"] in runs else 0
            for prog, runs in SPEC_KERNEL_RUN.items()}
        row["launches_long"] = {
            kind: long_launches[phase][run][row["name"]]
            for kind, (phase, run) in LONG_KERNEL_RUN.get(row["name"], {}).items()}
        row["launches_serve"] = serve_launches[row["name"]]
        row["launches_mutate"] = mutate_launches[row["name"]]
        row["launches_cold"] = cold_launches[row["name"]]
        row["launches_fleet"] = fleet_launches[row["name"]]
        row["launches_live"] = live_launches[row["name"]]
        row["launches_autopilot"] = pilot_launches[row["name"]]
        row["launches_disk"] = disk_launches[row["name"]]
        row["launches_variants"] = variants_launches[row["name"]]
        row["launches_dist"] = dist_launches[row["name"]]
        held = [r["max_abs_err"] for r in dist_rows if r["kernel"] == row["name"]]
        row["max_abs_err"] = max([row["max_abs_err"]] + held)
        if row["name"] in variant_rows:  # the bf16 and weighted forms, rows 1, 2 and 6
            row["variants"] = variant_rows[row["name"]]
        for errs in (mutate_err, live_err):
            if row["name"] in errs:
                row["max_abs_err"] = max(row["max_abs_err"], errs[row["name"]])
    print(json.dumps({"timeline": timeline()}), flush=True)
    emit({"phase": "total", "seconds": time.perf_counter() - t_smoke,
          "loadavg": os.getloadavg()})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        signal.signal(sig, on_stop_signal)
    start_watchdog()
    rc = 1
    try:
        rc = main()
    except PhaseFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
    except Stopped as e:
        print(f"chip_smoke: stopped by {e}", file=sys.stderr)
        rc = 143
    except BaseException:
        traceback.print_exc()
    finally:
        try:
            teardown(finished=rc == 0)
        finally:
            # everything the run started is stopped: skip the interpreter's
            # exit, whose hooks (CUDA's, the thread pools') have nothing
            # left to do and could only wait on a thread a phase left behind
            os._exit(rc)

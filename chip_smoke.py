#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`openwhisk_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. card     the card's name and power limit (nvidia-smi)
  2. build    the placement kernels (and the grid- and cluster-barrier
              probes) built with nvcc for sm_90a from
              openwhisk_tpu_torch/csrc, one nvcc per source, in parallel
  3. kernels  each kernel against its plain PyTorch version on the card at
              the full geometry (10,000 invokers padded to N = 16,384,
              A = 4,096 concurrency slots): the scan at B in {8, 16, 256},
              the repair at B in {8, 16, 32, 256, 1024} (the shadow
              pass runs it at every bucket), with and without a
              penalty, over six traffic families. Bit-exact: chosen,
              forced, rounds, free and conc. Times from CUDA events at
              B = 16 / 256 on memory-dominant traffic, with and without the
              penalty. The release fold (csrc/release_fold.cu) at R in
              {8, 16, 32, 256, 1,024, 1,500} rows against both plain folds
              (`release_batch`, `release_batch_vector`), bit-exact in free
              and conc (three seeds at each R), each R timed
              beside its byte bound, its device time (profiler) and the
              floor: one empty kernel launched through the same ctypes
              path on the same stream just before (both behind the
              books' restore); the plain folds timed up to 256 rows.
  4. main     `BalancerCore(device="cuda")` over 10,000 invokers of
              8,192 MB (managed 0.9 / blackbox 0.1, max_batch 256,
              action_slots 4096): warm-up, full 256-row batches of a
              Zipf(1.1) mix over 2,000 actions with completions 1-8 steps
              later and 1% of the invokers flapping every 20 steps, a
              trickle of 1-16-row steps (the scan kernel) and an overload
              burst under a blackbox outage (forced placements). Steps
              150-179 run under `torch.profiler` (the "profile" line:
              device time by kernel kind, the device's idle share and
              longest idle gaps, host time and device span of each phase of
              the fused step, the repair kernel's ms per launch and per
              round); the inputs of step 200's repair launch and
              release fold and of the first scan launch from step 360 on
              (a trickle step) are kept, every kernel must launch, and every scan launch of the run is timed with CUDA
              events. The first 110
              steps are replayed through `BalancerCore(device="cpu")` and
              must agree in decisions, rounds and books.
  5. each kernel on its kept main-path batch: held against the plain
     version, timed with and without a penalty, with its bound from the
     same inputs (the release fold against both plain folds, timed); its cost per round (repair) or per request (scan) on
     serial batches (one commit a round, every request on one invoker);
     one grid barrier at the repair's launch shape, and at the scan's one
     cluster barrier and one exchange of its minima (the kernel's and its
     first design's).
  5b. wide   the scan past 2^17 padded invokers (its wide instance:
              registers, shared memory and streamed columns): B = 16 at
              N = 262,144 (140,000 invokers, the balancer's managed 0.9 /
              blackbox 0.1 partitions, A = 4,096) and at N = 1,048,576
              (1,000,000 invokers, windows of up to 2^17, A = 256), each
              bit-exact against the plain version with and without a
              penalty, timed with CUDA events beside its bound and launch
              shape; then `TpuBalancer()` over 140,000 invokers registered
              by pings (books grown to N = 262,144 on the card) takes 20
              single invokes, each placed by the scan, and the first
              scan launch's batch is held against the plain version and
              timed the same way.
  6. scan-pinned main path: `BalancerCore(placement_kernel="scan")`, 40 full
     256-row steps of the same traffic (step p50, scan launches, each
     launch timed with CUDA events); its first 10 steps are replayed on
     the CPU and must agree in decisions and books.
  6b. planes  the device planes at the full fleet (N = 16,384, 24 latency
              buckets, 256 namespace rows): the telemetry fold
              (`record_packed`) on the card against the NumPy twin at
              E in {8, 64, 4096} with duplicate indices, padding rows and
              overflow latencies (integers exact, float sums within
              rtol 1e-5); 30 anomaly ticks on the card (three slow
              invokers, an error burst) against `anomaly_step_np` (flags
              exact except where the twin's score lies within the stated
              tolerance of its threshold, counted; scores within rtol and
              atol 1e-5) and bit-exact against the same torch step on the
              CPU; the planes' fold and `AnomalyPlane.tick` under
              `torch.cuda.set_sync_debug_mode("error")`; each program
              timed with CUDA events beside its byte bound (for the fold,
              the cells its events touch; the out-of-place copy of the
              whole state is a separate reading), and its kernels' device
              time from `torch.profiler`.
  7. front    the load balancer front, `TpuBalancer()` on the card, over
              the in-memory bus: 10,000 simulated invokers register by
              pings through its supervision pool (the books grow from
              initial_pad 64 to 16,384 rows on the card), then
              `publish_many` waves of 256 rows of phase 4's action mix,
              acked by the fleet 1-8 waves later (one fleet task drains
              every invoker topic), 1% of the invokers turned unhealthy
              through the supervision FSM and back by a ping, waves 40-69
              under `torch.profiler` (the device's idle share), and a
              1-16-row trickle once the releases have drained (the scan);
              then a second balancer with `rate_limit_per_minute` over 16
              waves (throttled rows). Every dispatched packed buffer, idle
              release fold and health set is recorded by wrapping the
              balancer's functions here, and replayed on the CPU through
              the plain fused steps from the same initial books: decisions,
              throttled bits, rounds and the final books must agree. Every
              activation must resolve, none stay active, and the books
              come back to full capacity. One "front" line of numbers.
              The host planes run at their defaults: the coalescing
              producer with the columnar batch wire (the fleet acks each
              wave as one frame, as an invoker's coalescing producer
              does), batched acks, the flight recorder, the trace store,
              and the host observatory installed on the loop; the line
              carries the frames and messages a frame for dispatches and
              acks ("wire"), the observatory's loop lag, GC pauses, tasks
              an invoke, serde by hop and the loop thread's samples by
              host layer ("host_observatory"), and the records filed.
              The device planes run at the JAX package's defaults too
              (telemetry folds on the dispatch cadence, the anomaly step
              and the HBM watermarks on the supervision tick, the
              profiler around the step entry points): "device_planes"
              carries the events observed, the folds and events still
              pending (must be 0), anomaly ticks run and harvested (at
              least one), the SLO count (every activation), the
              signature census (no churn), the kernel builds, HBM in use
              (above 0) and the fold's and the anomaly step's device time
              inside the profile window. A failure a plane logs and
              swallows (a failed fold or step) fails the phase through
              those counters. Then the planes A/B ("planes_ab" lines):
              phase 7's traffic at 12 waves with the three planes off,
              then on (step p50, activations/s, placement p50).
  7q. quality the placement quality plane and its shadow pass at phase 7's
              geometry, three "quality" lines. (a) `auto`: phase 7's
              balancer with `CONFIG_whisk_placementQuality_enabled` and a
              shadow pass every 4 batches, the anomaly plane at its
              defaults and a journal attached, 40 waves and a 6-step
              trickle; at wave 4 the 4 invokers that have received the
              most start acking 16 waves late, and the supervision's tick
              also runs every 2 waves. Held: the shadow launched the
              penalized repair (`penalized_launches`), every step scored
              and every 4th shadowed with no failure swallowed, the
              stragglers flagged and their passes divergent, the plane's
              three /metrics families, the journal replayed on the CPU to
              the card's decisions and books (the shadow wrote nothing
              live), a kept flagged shadow pass bit-exact with the plain
              shadow step, a kept scored batch against the NumPy twin
              (integers exact, floats within rtol 1e-5, atol 1e-4), and
              the kept penalized launch against its plain version, and
              the first penalized launch below 32 rows (a trickle pass)
              against its plain version with the flagged penalty. Timed
              with CUDA events: the pass, its book copy alone, the
              penalized repair beside the same batch unpenalized, the
              scorer's device ms and its host enqueue ms a batch; the
              step p50 beside phase 7's. (b) the scan-pinned balancer
              (`placement_kernel="scan"`), a shadow every 2 batches over
              10 waves, (a)'s straggler flags set in its anomaly plane's
              scores at every wave: the penalized scan launched, every
              step scored and every 2nd shadowed with no failure
              swallowed, flagged passes divergent, a kept flagged pass
              bit-exact, its kept launch timed. (c) 8b's assembly with
              the plane on over 320 invokes: `/admin/placement/quality`
              and `?raw=1` count every invoke, every step scored and
              every 16th shadowed (the penalized repair launched), no
              quality or shadow failure logged, `/metrics` carries the
              plane's families.
  7m. mesh    the fleet mesh (`openwhisk_tpu_torch/parallel/`), 8 shards
              on the card, four "mesh" lines. (a) "ops": phase 3's
              books at N = 16,384, A = 4,096, B = 16 (six families) and
              B = 256 (memory, container, oob): the sharded scan, the sharded repair (plain and
              penalized) and the owner-masked release vector against the
              single-device CUDA kernels (and the plain release vector):
              decisions, rounds and books equal, no placement kernel
              launched; then one fused step of 256 rows on the mesh and
              on one device: equal, with its device events (profiler),
              host syncs and CUDA-event time each, and the bytes of one
              shard; the mesh's release fold is one release-kernel launch
              a shard with no host sync (the fused step's and the
              release-only fold's, counted apart from the placement
              kernels). (b) "front": phase 7's front at 20 waves and a
              6-step trickle through `TpuBalancer(fleet_mesh=True,
              fleet_shards=8)` with a journal, and through the
              single-device card balancer: step p50/p99 of each; the mesh
              launched no placement kernel; its recorded steps replay
              through the single-device card functions to the same
              decisions and books; its per-shard occupancy rows sum to
              the fleet; its journal replays on the CPU at 8 shards to
              the same books and cold-starts at one (`mesh_topology`);
              its snapshot restores onto a single-device card balancer
              with equal books. (c) "quality": (b)'s runs have the
              quality plane on, a shadow every 4 batches and 100 invokers
              flagged as stragglers: the mesh's steps all scored, every
              4th shadowed, and a kept flagged pass equals the
              single-device plain penalized repair on the same books; the
              scorer's gather of the books timed beside its bytes. (d)
              "wide":
              140,000 invokers at N = 262,144 and A = 1,024 restored from
              one snapshot into the mesh and the single-device card
              balancer, 4 waves of 256 rows each: the same decisions and
              books.
  7b. journal the placement journal, snapshot and replay at phase 7's
              geometry: `TpuBalancer()` on the card with a
              `PlacementJournal` attached before the fleet registers, 24
              waves of phase 7's traffic (acks 1-8 waves later, the 1%
              flap, the trickle), a snapshot dumped through
              `BalancerSnapshotter._dump()` at wave 12 (captured on the
              loop, written on a worker thread), then a rate-limited
              balancer's 8 waves with a journal of its own. Replays: (a) a
              cold card balancer restores the snapshot and replays the
              tail, (b) another replays the full history with no
              snapshot, each bit-exact with the live books, no parity
              mismatch, both kernels launched in the replay (each launch
              bracketed by CUDA events, host syncs counted under torch's
              sync debug mode); (c) the same history through the plain
              versions on the CPU (`make_offline_balancer(device="cpu")`)
              to the same books; (d) the rate-limited journal on the card;
              (e) `JournalDebugger` on the card stops at the snapshot's
              seq with `diff_books` matching and at a wave-20 activation
              with its decisions derived as recorded. One "journal" line:
              records and bytes by type, `_journal_append` µs a record,
              fsync p99, the largest lag, the snapshot's capture and write
              ms and bytes, restore ms, replay rates, syncs, launches and
              kernel ms, and activations/s and step p50 with the journal
              on beside phase 7's run with it off.
  8. http     8a the standalone with real sandboxes; 8b the same assembly
              over the simulated fleet at 10,000 invokers, 8,000 blocking
              invokes at 256 in flight from a client process then 200 one
              at a time, with the planes at their defaults
              (`Controller.start` installs the observatory) and the same
              readings as phase 7; once drained, `/admin/slo`,
              `/admin/alerts`, `/admin/anomalies` and
              `/admin/profile/kernel` over HTTP must answer 200, the SLO
              count must equal the invokes and the kernel profile show no
              churn and the kernel builds; 8c two runs of 8b's configuration at
              1,000 invokes, the coalescing producer on, then off
              ("http_ab" lines: invokes/s, HTTP p50/p99, server CPU an
              invoke); 8d the restart: 8b's assembly over the simulated
              fleet with `snapshot_path`, `snapshot_interval` and
              `journal_dir` and a sqlite store, 1,000 blocking invokes,
              `stop()` (the final dump), a second standalone from the same
              files (`/admin/ready` 200 with the journal attached and not
              stalled, 10,000 invokers restored, the books the final
              dump's), 200 more invokes; each boot's restore and replay
              seconds ("restart" line).
  9. deploy  the multi-process deployment over the port's TCP bus: the
              broker (`python -m openwhisk_tpu_torch.messaging`), 4
              invokers (`python -m openwhisk_tpu_torch.invoker`, python:3
              sandboxes, 4,096 MB each) and one controller (the CLI's
              `main()` with `--balancer tpu` on the card, `--seed-guest`,
              a journal and a snapshot, `CONFIG_whisk_limits_*` raised for
              the run), each an OS process on localhost. Over HTTP: all 4
              invokers up, one echo action (128 MB), one cold blocking
              invoke, 64 non-blocking invokes at once (one admission wave,
              a step of 32 rows or more: the repair; up to three waves
              until the controller has launched it), every activation
              polled until recorded, 200 blocking invokes at 16 in flight,
              50 one at a time (the scan). Every response 200 with its
              echo, `/admin/ready` 200 with the journal attached,
              `/admin/profile/kernel` with both kernels loaded from phase
              2's build (no nvcc in the controller) and no churn. The
              controller process keeps the kernel wrappers' launch counts:
              chip_smoke resets them (SIGUSR2) before the traffic and
              reads them (SIGUSR1) after it (`--deploy-controller`). Then
              SIGTERM to every process (each exits 0; the controller
              writes its final dump), and the controller's journal is
              replayed here with `make_offline_balancer`: on the card
              (both kernels launched, 0 parity mismatches, the final
              dump's books) and on the CPU (the same books). One "deploy"
              line: process start seconds, the first invoke's ms,
              invokes/s and HTTP p50/p99 (client clock), the controller's
              step p50 from its kernel profile and its latency waterfall's
              stage medians (`/admin/latency/waterfall`), its launches, and the
              replays' launches, kernel ms and batches/s. About 20 s on
              an NVIDIA H100 80GB HBM3 at 700 W. The monitoring service
              runs beside them as its own process (`python -m
              openwhisk_tpu_torch.controller.monitoring --bus ...`): the
              smoke publishes USER_EVENTS activation `EventMessage`s onto
              the bus itself (no controller or invoker of either package
              publishes them) and holds that its /metrics counts them.
  9c. cold   a checkout with no build directory. First each batch bucket
              (8 to 256) on phase 7's path (`TpuBalancer()` over phase
              7's fleet): its first step's dispatch-to-readback ms against
              its repeats ("buckets" line). Then the package (not the
              repository's build/) copied into a temporary root and its
              standalone started from there (`--cold-standalone`), twice:
              the early build on (the default), then
              `CONFIG_whisk_loadBalancer_prewarm=false`. Each: seconds to
              /admin/ready, the first blocking invoke's ms, waves of 64
              blocking invokes until both kernels launched, nvcc seconds
              from the build census, the loop lag through the first invoke
              and over the first 20 s. Held: every invoke 200 with its
              echo, both kernels launched and built by nvcc in that
              process; prewarm on, the loop lag's max under 0.25 s through
              the first invoke (the window nvcc ran in); prewarm off, the
              first invoke at least the scan's nvcc seconds.
 10. ha     the controller tier.
              10a (in one process, "absorb" line): three `TpuBalancer()` on
              the card over phase 7's fleet (10,000 invokers registered by
              pings, N = 16,384, A = 4,096), in partition mode (a ring of
              8), each with its own journal under one root, one shared
              in-memory bus, a `ControllerMembership` each (the ring's
              claims at the default 1 s heartbeat and 5 s member timeout)
              and the controller CLI's partition callback (absorb from the
              previous owner's journal and snapshot, then place), a
              spillover sender and receiver each. Waves of phase 7's mix
              are routed to each namespace's owner with a trickle of
              single-row publishes (the scan); rows sent to a non-owner
              are refused with the reference's text; one hot namespace's
              non-blocking burst spills past `spillover_depth` to a peer;
              snapshots at wave 4. At wave 9 controller 2 is stopped (its
              membership silent, no leave, no final dump) and dropped from
              the survivors' view: they claim its partitions at higher
              epochs and absorb its tail on the card. Held: each absorb's
              books equal the same tail replayed on the CPU onto the same
              pre-absorb books (bit for bit, same statistics), each absorb
              launched the kernels (both kernels across them), none
              skipped, every row dispatched exactly once, the survivors own
              every partition at higher epochs, and the port's invoker
              fence discards a dead owner's late dispatch after a
              survivor's newer one. Reported: absorb ms, batches and
              records a partition, and the claims after the kill beyond
              the dead owner's (ownership flapping while the loop is
              blocked).
              10b (processes, "ha" line): the broker and 4 invokers, then
              3 controllers on the card with `--ha` and
              `CONFIG_whisk_ha_activeActive` (8 partitions; a journal and
              a snapshot at 1 s each) behind the port's edge, 16 tenants
              (two a partition) invoking an action that writes one file an
              execution, open loop without retries at 10 a second for
              12 s, controller 1 SIGKILLed at 4 s; then 2 controllers in
              active/standby (`CONFIG_whisk_ha_failover_enabled`, one
              snapshot and journal) with the active SIGKILLed the same
              way. Held: no execution twice, every tenant served after the
              kill, the survivors own all 8 partitions (the dead owner's
              at higher epochs), the promoted standby active at epoch 2 or
              more, the survivors' kernels launched (SIGUSR2/SIGUSR1 as in
              phase 9). Reported: failover downtime (kill to the first 200
              of a dead owner's tenant), invokes/s, HTTP p50/p99 before
              and after. The fleet observatory ("fleet" line), on by
              default in every controller: before the kill,
              /admin/fleet/{metrics,slo,waterfall,host,timeline} from one
              controller (each GET timed), each 200 with 3 members and
              none missing, the merged SLO count and waterfall `finished`
              equal to the sums of the members' own, read directly before
              and after; right after the kill /admin/fleet/metrics with
              the dead controller still in the directory labels it
              missing; the `chaos_kill` mark (this script's
              `time.monotonic()`) merged with a survivor's
              /admin/fleet/timeline from the mark on and split by
              `reconstruct_phases` (detect, claim, absorb, first
              placement): complete, its downtime at most the client's.
              The active/standby pair's split is reported as it comes
              back (its marks are partition marks: incomplete).
              10c ("funnel" line): 1 `--role balancer` on the card and 2
              `--role frontend --funnel-depth 64` behind the edge: 200
              blocking invokes at 16 in flight, 64 non-blocking (each
              recorded), a burst of 160 at one frontend (the overflow
              answers the front door's exact 429 text). Held: every invoke
              answered with its echo, the frontends hold no CUDA context
              (`nvidia-smi --query-compute-apps`), the balancer launched
              the kernels.
 12. tools  the reference's documented deployment shape (`deploy/README.md`,
              `deploy/cluster.yaml`'s keys in a JSON inventory) through the
              port's own tools: the services `python -m
              openwhisk_tpu_torch.tools.deploy` lists (the broker, the
              docstore over a sqlite file, 4 invokers of 4,096 MB, 2
              controllers with `--balancer tpu` on the card and
              `--seed-guest`, the monitoring service and the edge; the
              limits raised as phase 9's), started as its `up` starts
              them (argv, environment, order, pid files), each
              controller's argv under `--deploy-controller` for its launch
              counts; then the tool's `status` (rc 0, every service up).
              Traffic: `python -m openwhisk_tpu_torch.tools.wskadmin --db
              docstore://... user create` makes a tenant whose printed key
              is used from then on; `wsk` processes through the edge
              (`action create` of an echo and a step action, `--sequence`,
              `package create` and `bind`, `action invoke --blocking
              --result`, `activation list` and `get`), each timed and its
              JSON held against the REST body; 2,000 echo actions at 128
              MB created over HTTP through the edge (the store's size);
              300 blocking invokes at 16 in flight, Zipf(1.1) over them,
              through the edge (which alternates the controllers); one
              burst of 64 non-blocking invokes at controller 0 (up to
              three until a repair launched), each read back through
              controller 1; 1,000 gets of action docs from a
              `RemoteArtifactStore` here. Then the tool's `down` (every
              pid gone within 30 s) and the docstore's sqlite file opened
              with `open_store(path)`. Held: every invoke answered with
              its echo, every acknowledged activation read back through
              the other controller and held by the file with the 2,000
              actions, both boot lines `device=cuda`, each controller
              launched the scan and the two the repair. One "tools" line:
              each service's seconds to its up line, each command's ms,
              docstore get p50/p99, invokes/s and HTTP p50/p99 (all, cold
              and warm), each controller's launches.
 13. loadgen the port's load generator and performance harness
              (`openwhisk_tpu_torch/tools/loadgen.py`,
              `openwhisk_tpu_torch/performance/`) on the card. (a)
              `sweep_balancer`: a live `TpuBalancer()` and the echo fleet
              (`tools/echo_fleet.py`) at 10,000 invokers, 8 actions of 128
              MB, Poisson arrivals from 64/s doubling (up to 2,048/s)
              while a rung is
              sustained (p99 from the scheduled arrival within 1,000 ms,
              98% completed, no errors, the generator within 50 ms of its
              schedule), then the last sustained rate re-measured; the
              fleet must register (the echo fleet's pinger spreads its
              pings over the second, 256 at a time); rerun at 1,024
              invokers when the sweep stopped at a rung failed on the
              generator alone. One "loadgen_sweep" line an attempt: the
              sustained activations/s, p50/p99 from the schedule, every
              rung's accounting and verdict with its blame, the
              waterfall's stage budget, `gc_tuned`, the launches, the
              balancer's steps and rows a step. (b) `python
              -m openwhisk_tpu_torch.tools.loadgen --rate 200 --duration 1
              --invokers 16` as a process: exactly one JSON line, from the
              card. (c) `multiproc_fixed_rate(shared=True, procs=2)` at
              half the rate (a)'s last sweep sustained and at least
              1,000/s (where the funnel completed nothing before the
              release kernel and its named cuts),
              which must complete every row with none
              failed on the funnel's retries, and at an eighth of that only
              when it does not (then the phase fails): one
              `--serve-funnel` process owns the card, two front-end
              workers funnel to it over the TCP bus; the processes run
              under `--loadgen-process`, which records each one's
              launches, CUDA state, the funnel process's hop (frames and
              rows received, outcome frames, steps, rows a step, host
              syncs on its loop under torch's sync debug mode) and each
              front end's retries and rows timed out ("loadgen_shared"
              line an attempt); then one balancer in this process at the
              first attempt's rate and 16 invokers, its rows a step beside
              the funnel process's ("loadgen_single_at_shared_rate"). (d) the
              performance harness against the port's standalone on the
              card: the latency (100 requests, one at a time), throughput
              (300 at 4), cold (20) and apiv1 (100) simulations, each
              through `simulations.run` (a non-200 invoke prints the
              standalone's log tail and the sandboxes' states when it came
              back); owperf (20 samples, 2 rules); the placement sweep at
              16, 256, 4,096 and 65,536 invokers, 64 requests a batch, on
              one device, on 8 shards and the scan kernel against its
              plain version; warm-hit
              parity at 64 invokers, 20 rounds of 128. Held: every rung's
              activations accounted for, (a)'s re-measured rate sustained
              with both kernels launched, (b)'s line, (c)'s workers
              without error and no CUDA context, each with work done in
              the last attempt, the funnel process's kernels launched, every
              simulation request 200, owperf's five phases, a sweep row
              for every size and configuration, warm-hit decision parity
              1.0 with equal warm rates.
 11. after phase 13, a `{"kernels": [...]}` JSON line (each kernel's
     launches and ms in the journal replays of 7b, phase 9's, 9c's, phase
     10's, phase 12's and phase 13's launches beside the rest; `quality_launches` and
     `penalized_launches` on 7q's paths and the kept penalized launch's
     numbers), then the card line, then the last line
     `{"ok": true, "device": {...}}`.

Any failure raises, so the script exits non-zero and prints no last line;
without a CUDA card, or outside the repository, it fails at once.

bound_ms is the least time the card could take for the kernel's work: the
larger of (bytes it must move) / 3.35 TB/s and (key evaluations) /
33.5 T int32 ops/s (half the 67 TFLOP/s float32 rate: Hopper issues 64
int32 against 128 float32 operations per SM and clock), counting one
operation a key. The key evaluations are what the exact algorithm needs on
these inputs: one forced-rotation key per valid row and column of its
partition window, plus one probe key per column of the window for every
probe (the scan probes each row once, the repair each pending row in
every round). The bytes are the request matrix, free and health over the
windows' union, each distinct conc row over the union of its rows'
windows, read once, and the outputs: chosen, forced, rounds and the book
cells that changed.
"""
import asyncio
import contextlib
import ctypes
import functools
import gc
import json
import math
import signal
import subprocess
import sys
import time

import numpy as np
import torch

N_INV, N_PAD, A = 10_000, 16_384, 4_096
MANAGED, BLACKBOX = int(0.9 * N_INV), int(0.1 * N_INV)
MEM_MB = 8_192
MAX_BATCH = 256
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 33.5e12
FAMILIES = ("memory", "burst", "container", "overload", "unhealthy", "oob")
CPU_STEPS = 110
DEVICE = "cuda"


def say(tag, **kw):
    print(json.dumps({"phase": tag, **kw}), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# ---------------------------------------------------------------- phase 3
def _inv(rng, size):
    st = rng.randint(1, size + 1)
    while math.gcd(int(st), int(size)) != 1:
        st = rng.randint(1, size + 1)
    return pow(int(st), -1, int(size)) if size > 1 else 0


def make_case(family, b, seed, torch, P):
    """Books and a request batch on the card for one traffic family."""
    rng = np.random.RandomState(seed)
    bb = rng.rand(b) < 0.1
    off = np.where(bb, MANAGED, 0)
    size = np.where(bb, BLACKBOX, MANAGED)
    home = rng.randint(0, 1 << 30, b) % size
    step_inv = np.array([_inv(rng, s) for s in size])
    need = rng.choice([128, 256, 512, 1024, 2048], b)
    slot = rng.randint(0, A, b)
    maxc = np.ones(b, int)
    rand = rng.randint(0, 1 << 30, b) % size
    valid = rng.rand(b) < 0.95
    free = np.zeros(N_PAD, np.int32)
    free[:N_INV] = MEM_MB
    health = np.zeros(N_PAD, bool)
    health[:N_INV] = True
    conc_p = 0.02
    if family == "burst":  # same-action runs onto nearly full invokers
        act = rng.randint(0, 4, b)
        off, size = np.zeros(b, int), np.full(b, MANAGED)
        home = rng.randint(0, MANAGED, 4)[act]
        step_inv = np.array([_inv(rng, MANAGED) for _ in range(4)])[act]
        slot, need = rng.randint(0, A, 4)[act], np.full(b, 256)
        free[:N_INV] = rng.randint(0, 1024, N_INV)
    elif family == "container":  # container-open rows on shared slots
        maxc = np.where(rng.rand(b) < 0.7, rng.randint(2, 17, b), 1)
        slot = rng.randint(0, 8, b)
        conc_p = 0.3
    elif family == "overload":  # demand far above capacity
        free[:N_INV] = np.where(rng.rand(N_INV) < 0.01, 2048, 0)
        need = rng.choice([1024, 2048], b)
    elif family == "unhealthy":  # half the fleet down, random windows
        health[:N_INV] = rng.rand(N_INV) < 0.5
        off = rng.randint(0, N_INV // 2, b)
        size = rng.randint(1, N_INV + 1, b) % (N_INV - off) + 1
        home = rng.randint(0, 1 << 30, b) % size
        step_inv = np.array([_inv(rng, s) for s in size])
        rand = rng.randint(0, 1 << 30, b) % size
    elif family == "oob":  # slots past the slot axis: read clamped, write dropped
        slot = np.where(rng.rand(b) < 0.25, A + rng.randint(0, 64, b), slot)
        maxc = np.where(rng.rand(b) < 0.4, rng.randint(2, 9, b), 1)
        conc_p = 0.2
    conc = torch.zeros((A, N_PAD), dtype=torch.int32, device=DEVICE)
    rows = np.unique(np.clip(slot, 0, A - 1))
    vals = np.where(rng.rand(len(rows), N_PAD) < conc_p,
                    rng.randint(1, 4, (len(rows), N_PAD)), 0)
    vals[:, N_INV:] = 0
    conc[torch.from_numpy(rows).to(DEVICE)] = torch.from_numpy(
        vals.astype(np.int32)).to(DEVICE)
    state = P.PlacementState(torch.from_numpy(free).to(DEVICE), conc.T,
                             torch.from_numpy(health).to(DEVICE))
    batch = P.request_batch_from_numpy(off, size, home, step_inv, need, slot,
                                       maxc, rand, valid, device=DEVICE)
    pen = torch.from_numpy(rng.randint(0, 4, N_PAD).astype(np.int32)).to(
        DEVICE)
    return state, batch, pen


def clone_state(P, s):
    return P.PlacementState(s.free_mb.clone(), s.conc_free.T.clone().T,
                            s.health.clone())


def run_pair(kind, state, batch, pen, P, K):
    """(kernel outputs, plain outputs), each on its own copy of the books."""
    ks, ps = clone_state(P, state), clone_state(P, state)
    if kind == "scan":
        kout = K.schedule_batch_cuda(K.to_transposed(ks), batch, pen)
        pout = P.schedule_batch(ps, batch, pen)
    else:
        kout = K.schedule_batch_repair_cuda(K.to_transposed(ks), batch, pen)
        pout = P.schedule_batch_repair(ps, batch, pen)
    return (ks, kout), (ps, pout)


def compare(kind, state, batch, pen, P, K, torch):
    (ks, kout), (ps, pout) = run_pair(kind, state, batch, pen, P, K)
    torch.cuda.synchronize()
    err = 0
    pairs = [(kout[1], pout[1]), (kout[2].int(), pout[2].int()),
             (ks.free_mb, ps.free_mb), (ks.conc_free, ps.conc_free)]
    if kind == "repair":
        pairs.append((kout[3].reshape(1), pout[3].reshape(1)))
    for x, y in pairs:
        err = max(err, int((x.long() - y.long()).abs().max()))
    rounds = int(kout[3]) if kind == "repair" else 0
    return err, rounds, int(kout[2].sum())


def work_bytes_ops(kind, state, batch, pen, P):
    """Bytes the call must move and key evaluations the exact algorithm
    needs (see the module docstring), from this run's inputs: the plain
    version runs once on a copy of the books and reports the pending rows
    of every repair round."""
    ps = clone_state(P, state)
    pending = []
    if kind == "scan":
        P.schedule_batch(ps, batch, pen)
    else:
        P.schedule_batch_repair(ps, batch, pen,
                                on_round=lambda p: pending.append(
                                    p.cpu().numpy()))
    n = state.free_mb.shape[0]
    a = state.conc_free.shape[1]
    b = batch.valid.shape[0]
    off = batch.offset.cpu().numpy().astype(np.int64)
    lo = np.clip(off, 0, n)
    hi = np.clip(off + batch.size.cpu().numpy(), lo, n)
    valid = batch.valid.cpu().numpy()
    width = np.where(valid, hi - lo, 0)
    # one forced-rotation key per valid row and window column, plus one
    # probe key per window column for every probe (the scan probes each
    # row once, the repair each pending row in every round)
    keys = int(width.sum()) + (int(width.sum()) if kind == "scan" else
                               sum(int(width[p].sum()) for p in pending))
    cols = np.zeros(n, bool)
    slot = np.clip(batch.conc_slot.cpu().numpy(), 0, a - 1)
    slot_cols = {}
    for i in np.nonzero(valid)[0]:
        cols[lo[i]:hi[i]] = True
        slot_cols.setdefault(slot[i], np.zeros(n, bool))[lo[i]:hi[i]] = True
    conc_cells = sum(int(m.sum()) for m in slot_cols.values())
    changed = (int((ps.free_mb != state.free_mb).sum())
               + int((ps.conc_free != state.conc_free).sum()))
    nbytes = (9 * 4 * b + 5 * int(cols.sum()) + 4 * conc_cells + 8 * b
              + (4 if kind == "repair" else 0) + 4 * changed)
    return nbytes, keys, len(pending)


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / INT32_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_ms(fn, restore, torch, reps=15):
    """Median CUDA-event time of fn(), the books restored before each
    call (outside the timed window)."""
    evs = []
    fn()  # warm
    for _ in range(reps):
        restore()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def kernel_phase(torch, P, K):
    results = {"scan": {"err": 0, "cases": 0, "times": {}},
               "repair": {"err": 0, "cases": 0, "rounds_max": 0,
                          "times": {}}}
    seed = 0
    for family in FAMILIES:
        for kind, bs in (("scan", (8, 16, 256)),
                         ("repair", (8, 16, 32, 256, 1024))):
            for b in bs:
                for use_pen in (False, True):
                    seed += 1
                    state, batch, pen = make_case(family, b, seed, torch, P)
                    err, rounds, n_forced = compare(
                        kind, state, batch, pen if use_pen else None, P, K,
                        torch)
                    r = results[kind]
                    r["err"] = max(r["err"], err)
                    r["cases"] += 1
                    if kind == "repair":
                        r["rounds_max"] = max(r["rounds_max"], rounds)
                    say("kernel_case", kernel=kind, family=family, B=b,
                        penalty=use_pen, max_abs_err=err, rounds=rounds,
                        forced=n_forced)
                    require(err == 0, f"{kind} {family} B={b} pen={use_pen}"
                                      f" differs from plain by {err}")
                    del state, batch, pen
    # times at B = 16 and 256 on memory-dominant traffic (one or two
    # repair rounds); the kernels line takes its main numbers from each
    # kernel's own main-path batch (main_path_kernel)
    for kind, b in (("scan", 256), ("repair", 16), ("scan", 16),
                    ("repair", 256)):
        state, batch, pen = make_case("memory", b, 1000 + b, torch, P)
        work = clone_state(P, state)
        kview = K.to_transposed(work)

        def restore():
            work.free_mb.copy_(state.free_mb)
            work.conc_free.copy_(state.conc_free)

        kfn = (K.schedule_batch_cuda if kind == "scan"
               else K.schedule_batch_repair_cuda)
        pfn = P.schedule_batch if kind == "scan" else P.schedule_batch_repair
        plain0 = time_ms(lambda: pfn(work, batch), restore, torch)
        ms = time_ms(lambda: kfn(kview, batch), restore, torch)
        plain1 = time_ms(lambda: pfn(work, batch), restore, torch)
        pen_ms = time_ms(lambda: kfn(kview, batch, pen), restore, torch)
        pen_plain_ms = time_ms(lambda: pfn(work, batch, pen), restore, torch,
                               reps=3)
        nbytes, ops, rounds = work_bytes_ops(kind, state, batch, None, P)
        pbytes, pops, prounds = work_bytes_ops(kind, state, batch, pen, P)
        bound_ms, bound_by = bound(nbytes, ops)
        pen_bound_ms, pen_bound_by = bound(pbytes, pops)
        row = dict(B=b, ms=ms, plain_ms=min(plain0, plain1), bytes=nbytes,
                   key_evals=ops, rounds=rounds, bound_ms=bound_ms,
                   bound_by=bound_by, penalized=dict(
                       ms=pen_ms, plain_ms=pen_plain_ms, bytes=pbytes,
                       key_evals=pops,
                       rounds=prounds, bound_ms=pen_bound_ms,
                       bound_by=pen_bound_by))
        results[kind]["times"][f"B{b}"] = row
        say("kernel_time", kernel=kind, family="memory", **row,
            plain_ms_both=[plain0, plain1])
        del state, batch, work, kview
    return results


def main_path_kernel(kind, box, torch, P, K):
    """A kernel on one batch of the main path, as the balancer handed it
    over (books after the step's release and health folds): held against
    the plain version, timed with and without a penalty, and its bound
    from the same inputs."""
    kfn, pfn = ((K.schedule_batch_cuda, P.schedule_batch) if kind == "scan"
                else (K.schedule_batch_repair_cuda, P.schedule_batch_repair))
    free0, conc0, health = box["state"]
    batch = box["batch"]
    work = P.PlacementState(free0.clone(), conc0.clone(), health)
    std = K.to_transposed(P.PlacementState(free0, conc0, health))

    def restore():
        work.free_mb.copy_(free0)
        work.conc_free.copy_(conc0)

    pen = torch.from_numpy(np.random.RandomState(11).randint(
        0, 4, free0.shape[0]).astype(np.int32)).to(free0.device)
    out = {}
    for label, p in (("plain", None), ("penalized", pen)):
        err, rounds, _ = compare(kind, std, batch, p, P, K, torch)
        require(err == 0, f"main-path {kind} ({label}) differs from plain "
                          f"by {err}")
        ms = time_ms(lambda: kfn(work, batch, p), restore, torch, reps=10)
        nbytes, ops, prounds = work_bytes_ops(kind, std, batch, p, P)
        require(prounds == rounds, "plain and kernel rounds agree")
        bound_ms, bound_by = bound(nbytes, ops)
        out[label] = dict(ms=ms, bytes=nbytes, key_evals=ops,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=err)
        if kind == "repair":
            out[label].update(rounds=rounds, ms_per_round=ms / rounds)
        out[label]["plain_ms"] = time_ms(
            lambda: pfn(K.to_transposed(work), batch, p), restore, torch,
            reps=3)
    out["B"] = int(batch.valid.shape[0])
    out["valid_rows"] = int(batch.valid.sum())
    if kind == "scan":
        out["cluster"] = K.schedule_batch_cuda.cluster
    else:
        out["grid"] = K.schedule_batch_repair_cuda.grid
    say("main_path_kernel", kernel=kind, **out)
    return out


#: the release fold's cases at the main path's geometry: rows a fold (1,500
#: crosses the kernel's 1,024-row chunk)
RELEASE_ROWS = (8, 16, 32, 256, 1024, 1500)


def release_rows(r, seed, n, a, torch):
    """R release rows on the card: concurrency rows crowd r // 3 cells (so
    groups of one cell form, some heterogeneous: other need or max_conc on
    one slot), a quarter memory rows, a fifth invalid."""
    rng = np.random.RandomState(seed)
    cells = max(1, r // 3)
    pool = np.stack([rng.randint(0, n, cells), rng.randint(0, a, cells)])
    pick = rng.randint(0, cells, r)
    maxc = rng.choice([1, 2, 3, 4, 8], r)
    maxc[rng.rand(r) < 0.25] = 1
    cols = [pool[0, pick], pool[1, pick], rng.choice([128, 256, 512], r),
            maxc]
    return ([torch.from_numpy(c.astype(np.int32)).to(DEVICE) for c in cols]
            + [torch.from_numpy(rng.rand(r) > 0.2).to(DEVICE)])


def release_bytes(rows):
    """Bytes the fold must move: each row read once (four int32 columns
    and the valid byte), free read and written at each invoker a valid
    row touches, each concurrency cell a valid concurrency row touches
    read and written."""
    inv, slot, _need, maxc, valid = (c.cpu().numpy() for c in rows)
    conc_rows = valid & (maxc > 1)
    cells = len(set(zip(inv[conc_rows].tolist(), slot[conc_rows].tolist())))
    return 17 * len(valid) + 8 * len(set(inv[valid].tolist())) + 8 * cells


def release_compare(books, rows, P, K, torch):
    """The kernel against both plain folds on copies of `books`: the
    largest absolute difference over free and conc."""
    err = 0
    outs = []
    for fn in (K.release_batch_cuda, P.release_batch,
               P.release_batch_vector):
        st = P.PlacementState(books[0].clone(), books[1].clone(), books[2])
        fn(st, *rows)
        outs.append(st)
    torch.cuda.synchronize()
    for o in outs[1:]:
        for x, y in ((outs[0].free_mb, o.free_mb),
                     (outs[0].conc_free, o.conc_free)):
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def release_times(books, rows, P, K, torch, reps=10):
    """CUDA-event times of the kernel and of both plain folds on the same
    books and rows (books restored outside the timed window), and the
    bound from the bytes the fold must move."""
    work = P.PlacementState(books[0].clone(), books[1].clone(), books[2])

    def restore():
        work.free_mb.copy_(books[0])
        work.conc_free.copy_(books[1])

    # the floor timed as the fold is: behind the books' restore, which
    # keeps the card busy while the host issues the launch
    floor_ms = time_ms(K.empty_launch_cuda, restore, torch, reps=reps)
    ms = time_ms(lambda: K.release_batch_cuda(work, *rows), restore, torch,
                 reps=reps)
    device_us = kernel_device_us(lambda: K.release_batch_cuda(work, *rows),
                                 restore, "release_fold_kernel", torch)
    # the plain folds repeat the kernel's arithmetic in torch ops (the
    # per-row one about 0.7 ms a row): timed up to 256 rows, the main
    # path's bucket; past it only held against the kernel
    plain_ms = vector_ms = None
    if len(rows[0]) <= 256:
        plain_ms = time_ms(lambda: P.release_batch(work, *rows), restore,
                           torch, reps=3)
        vector_ms = time_ms(lambda: P.release_batch_vector(work, *rows),
                            restore, torch, reps=3)
    nbytes = release_bytes(rows)
    bound_ms, bound_by = bound(nbytes, len(rows[0]))
    return dict(R=len(rows[0]), valid_rows=int(rows[4].sum()), ms=ms,
                floor_ms=floor_ms, device_us=device_us, plain_ms=plain_ms,
                vector_ms=vector_ms, bytes=nbytes, bound_ms=bound_ms,
                bound_by=bound_by)


def kernel_device_us(fn, restore, match, torch, reps=10):
    """Median device time in microseconds of the kernel whose name holds
    `match`, one fn() a rep under torch.profiler (restore() between)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=PROFILE_ACTIVITIES) as prof:
        for _ in range(reps):
            restore()
            fn()
        torch.cuda.synchronize()
    cuda_t = torch.autograd.DeviceType.CUDA
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == cuda_t and match in e.name]
    return float(np.median(us)) if us else None


def launch_floor(times, torch, K):
    """The practical floor under a fold: one empty kernel launched through
    the same ctypes path on the same stream, CUDA-event timed as the fold
    is (behind the books' restore) right before each R's fold (`ms`: their
    median; `ms_by_R`), and its device time (`device_us`)."""
    by_r = {k: v["floor_ms"] for k, v in times.items()}
    return dict(ms=float(np.median(list(by_r.values()))), ms_by_R=by_r,
                device_us=kernel_device_us(K.empty_launch_cuda,
                                           lambda: None, "empty_kernel",
                                           torch))


def release_phase(torch, P, K):
    """Phase 3's release fold: the kernel against both plain folds at the
    full geometry (N = 16,384, A = 4,096), R in RELEASE_ROWS, each timed
    beside its bound."""
    free = torch.from_numpy(np.random.RandomState(5).randint(
        0, MEM_MB, N_PAD).astype(np.int32)).to(DEVICE)
    conc = torch.from_numpy(np.random.RandomState(6).randint(
        0, 6, (N_PAD, A)).astype(np.int32)).to(DEVICE)
    books = (free, conc, torch.ones(N_PAD, dtype=torch.bool, device=DEVICE))
    out = {"err": 0, "cases": 0, "times": {}}
    for r in RELEASE_ROWS:
        for seed in range(3):
            rows = release_rows(r, 100 * r + seed, N_PAD, A, torch)
            err = release_compare(books, rows, P, K, torch)
            out["err"] = max(out["err"], err)
            out["cases"] += 1
            say("kernel_case", kernel="release", R=r, seed=seed,
                max_abs_err=err)
            require(err == 0, f"release R={r} seed={seed} differs from "
                              f"plain by {err}")
        row = release_times(books, release_rows(r, r, N_PAD, A, torch),
                            P, K, torch)
        out["times"][f"R{r}"] = row
        say("kernel_time", kernel="release", **row)
    out["launch_floor"] = launch_floor(out["times"], torch, K)
    say("kernel_time", kernel="empty_launch", **out["launch_floor"])
    return out


def capture_release(TB):
    """Route the balancer's release folds through a wrapper that keeps a
    copy of the first one's inputs (books and rows). Returns (box,
    undo)."""
    real = TB.release_batch_cuda
    box = {}

    def keep(state, *rows):
        if not box:
            box["state"] = tuple(t.clone() for t in state)
            box["rows"] = tuple(c.clone() for c in rows)
        return real(state, *rows)

    TB.release_batch_cuda = keep
    return box, lambda: setattr(TB, "release_batch_cuda", real)


def main_path_release(box, torch, P, K):
    """The release kernel on one fold of the main path, as the balancer
    handed it over: held against both plain folds and timed beside its
    bound."""
    books, rows = box["state"], box["rows"]
    err = release_compare(books, rows, P, K, torch)
    require(err == 0, f"main-path release differs from plain by {err}")
    out = dict(release_times(books, rows, P, K, torch), max_abs_err=err)
    say("main_path_kernel", kernel="release", **out)
    return out


def serial_cost(kind, torch, P, K):
    """A kernel's cost per serial step apart from its probe: B
    container-opening rows on the same one-invoker window and slot. The
    repair commits one row a round (each later row conflicts with the row
    before), so rounds = B; the scan's every request commits at the same
    cell that the requests after it have already prefetched, which pins
    the owner's patch rule. Held against the plain version too."""
    out = {}
    for b in ((16, 256) if kind == "scan" else (32, 256)):
        ones = np.ones(b, int)
        batch = P.request_batch_from_numpy(
            0 * ones, ones, 0 * ones, 0 * ones, 128 * ones, 0 * ones,
            4 * ones, 0 * ones, ones.astype(bool), device=DEVICE)
        free = np.zeros(N_PAD, np.int32)
        free[:N_INV] = MEM_MB
        free[0] = 1 << 30
        health = np.zeros(N_PAD, bool)
        health[:N_INV] = True
        state = P.PlacementState(
            torch.from_numpy(free).to(DEVICE),
            torch.zeros((A, N_PAD), dtype=torch.int32, device=DEVICE).T,
            torch.from_numpy(health).to(DEVICE))
        err, rounds, _ = compare(kind, state, batch, None, P, K, torch)
        require(err == 0 and (kind == "scan" or rounds == b),
                f"serial {kind} case B={b}: err {err}, rounds {rounds}")
        work = clone_state(P, state)

        def restore():
            work.free_mb.copy_(state.free_mb)
            work.conc_free.copy_(state.conc_free)

        kfn = (K.schedule_batch_cuda if kind == "scan"
               else K.schedule_batch_repair_cuda)
        ms = time_ms(lambda: kfn(K.to_transposed(work), batch), restore,
                     torch, reps=10)
        steps = b if kind == "scan" else rounds
        out[f"B{b}"] = {"ms": ms, "max_abs_err": err,
                        ("us_per_request" if kind == "scan"
                         else "us_per_round"): ms * 1e3 / steps}
        if kind == "repair":
            out[f"B{b}"]["rounds"] = rounds
    say("serial_cost", kernel=kind, **out)
    return out


def per_op_us(run, torch):
    """The cost of one of the operations a probe kernel repeats: run(count)
    launches it, timed at 2,000 and at 0; (us per operation, ms by count)."""
    ms = {c: time_ms(lambda: run(c), lambda: None, torch, reps=10)
          for c in (0, 2000)}
    return (ms[2000] - ms[0]) * 1e3 / 2000, ms


def barrier_cost(torch, K, _build):
    """One cooperative grid barrier at the repair kernel's launch shape:
    csrc/grid_barrier.cu runs only barriers."""
    fn = _build.load("grid_barrier").grid_barrier_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = K.schedule_batch_repair_cuda.grid["blocks"]
    stream = torch.cuda.current_stream().cuda_stream

    def run(syncs):
        rc = fn(syncs, blocks, stream)
        require(rc == 0, f"grid_barrier launch: CUDA error {rc}")

    us, ms = per_op_us(run, torch)
    say("grid_barrier", blocks=blocks, threads=1024, ms=ms,
        us_per_barrier=us)
    return us


#: csrc/cluster_barrier.cu's modes: what the scan pays once a request
CLUSTER_MODES = ("cluster_barrier", "exchange", "first_design_exchange")


def cluster_cost(torch, K, _build):
    """At the scan's launch shape (one cluster), the cost of one cluster
    barrier, of one exchange of the scan's two minima a thread, and of the
    same exchange as the scan's first design made it: csrc/
    cluster_barrier.cu runs only those."""
    fn = _build.load("cluster_barrier").cluster_barrier_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = K.schedule_batch_cuda.cluster["blocks"]
    stream = torch.cuda.current_stream().cuda_stream
    sink = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    out = {}
    for mode, name in enumerate(CLUSTER_MODES):
        def run(count):
            rc = fn(count, blocks, mode, sink.data_ptr(), stream)
            require(rc == 0, f"cluster_barrier mode {mode}: CUDA error {rc}")

        out[f"{name}_us"] = per_op_us(run, torch)[0]
    say("cluster_cost", blocks=blocks, threads=1024, **out)
    return out


# ---------------------------------------------------------------- phase 4
class Traffic:
    """A seeded activation stream against one BalancerCore: a Zipf(1.1)
    mix over 2,000 actions (memory 128-2048 MB, max_conc 2-16 for a fifth,
    blackbox for 5%), completions 1-8 steps after placement, 1% of the
    invokers flapping health every 20 steps."""

    def __init__(self, seed, n_actions=2000):
        self.rng = rng = np.random.RandomState(seed)
        p = np.arange(1, n_actions + 1, dtype=float) ** -1.1
        self.p = p / p.sum()
        self.mem = rng.choice([128, 256, 512, 1024, 2048], n_actions)
        self.maxc = np.where(rng.rand(n_actions) < 0.2,
                             rng.randint(2, 17, n_actions), 1)
        self.blackbox = rng.rand(n_actions) < 0.05
        pb = np.where(self.blackbox, self.p, 0.0)
        self.p_blackbox = pb / pb.sum()
        self.ns = [f"ns{k % 200}" for k in range(n_actions)]
        self.fqn = [f"ns{k % 200}/pkg/action{k}" for k in range(n_actions)]
        self.healthy = np.ones(N_INV, bool)
        self.due = {}
        self.step_no = 0

    def flip(self, core, idxs, usable=None):
        for i in idxs:
            v = (not self.healthy[i]) if usable is None else usable
            self.healthy[i] = v
            core.set_health(int(i), bool(v))

    def advance(self, core, n_rows, blackbox_only=False):
        rng = self.rng
        for c in self.due.pop(self.step_no, []):
            core.complete(*c)
        if self.step_no and self.step_no % 20 == 0:
            self.flip(core, rng.choice(N_INV, N_INV // 100, replace=False))
        acts = rng.choice(len(self.p), n_rows,
                          p=self.p_blackbox if blackbox_only else self.p)
        core.submit([core.build_row(self.ns[a], self.fqn[a],
                                    int(self.mem[a]), int(self.maxc[a]),
                                    bool(self.blackbox[a])) for a in acts])
        t0 = time.perf_counter()
        with torch.profiler.record_function("balancer_step"):
            res = core.step()
        dt = time.perf_counter() - t0
        delays = rng.randint(1, 9, len(res.chosen))
        for k, inv in enumerate(res.chosen):
            if inv >= 0:
                self.due.setdefault(self.step_no + int(delays[k]), []).append(
                    (int(inv), int(res.rows[5, k]), int(res.rows[4, k]),
                     int(res.rows[6, k]), res.slot_keys[k]))
        self.step_no += 1
        return res, dt


def schedule():
    """(name, rows, blackbox_only, outage) per step; the first CPU_STEPS
    cover warm-up, full batches, trickle and the overload burst."""
    plan = [("warmup", MAX_BATCH, False, None)] * 4
    plan += [("full", MAX_BATCH, False, None)] * 56
    plan += [("trickle", None, False, None)] * 20
    plan += [("overload", MAX_BATCH, True, "down")]
    plan += [("overload", MAX_BATCH, True, None)] * 17
    plan += [("overload", MAX_BATCH, True, "up")]
    plan += [("overload", MAX_BATCH, True, None)] * 11
    plan += [("full", MAX_BATCH, False, None)] * 250
    plan += [("trickle", None, False, None)] * 20
    return plan


def drive(core, traffic, plan):
    """Run `plan` on core; yields (name, StepResult, seconds) per step."""
    outage = np.arange(N_INV - BLACKBOX + 10, N_INV)  # 990 blackbox invokers
    for name, rows, bb_only, out in plan:
        if out == "down":
            traffic.flip(core, outage, usable=False)
        elif out == "up":
            traffic.flip(core, outage, usable=True)
        n = rows if rows is not None else int(traffic.rng.randint(1, 17))
        res, dt = traffic.advance(core, n, blackbox_only=bb_only)
        yield name, res, dt


def capture_next(TB, attr):
    """Route the balancer's launches of kernel wrapper `attr` through a
    wrapper that keeps a copy of the first one's inputs (kernel layout).
    Returns (box, undo)."""
    real = getattr(TB, attr)
    box = {}

    def keep(state, batch, penalty=None):
        if not box:
            box["state"] = tuple(t.clone() for t in state)
            box["batch"] = type(batch)(*(c.clone() for c in batch))
        return real(state, batch, penalty)

    setattr(TB, attr, keep)
    return box, lambda: setattr(TB, attr, real)


def time_launches(TB, attr):
    """Route the balancer's launches of kernel wrapper `attr` through a
    wrapper that brackets each with CUDA events (no synchronisation).
    Returns (event pairs, undo)."""
    real = getattr(TB, attr)
    pairs = []

    def timed(*args, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = real(*args, **kw)
        e.record()
        pairs.append((s, e))
        return out

    setattr(TB, attr, timed)
    return pairs, lambda: setattr(TB, attr, real)


def launch_ms(pairs):
    """(median, count) of the timed launches' ms; call after a sync."""
    ms = [s.elapsed_time(e) for s, e in pairs]
    return (float(np.median(ms)) if ms else None), len(ms)


def _kind(name):
    if "placement_repair" in name:
        return "repair_kernel"
    if "placement_scan" in name:
        return "scan_kernel"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name.split(" (")[0]
    return "torch_ops"


def _union_ms(intervals, lo, hi):
    """Length of the union of (start, end) intervals clipped to [lo, hi)."""
    busy, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy


def device_profile(prof, torch, rounds):
    """Device time by kernel kind, the device's idle share over the
    profiled window and inside the steps (host range "balancer_step"), its
    longest idle gaps, the host time and device span of each named phase
    of the fused step, and the repair kernel's time per launch and per
    round."""
    cpu_t, cuda_t = torch.autograd.DeviceType.CPU, \
        torch.autograd.DeviceType.CUDA
    spans = ("balancer_step", "release_fold", "health_fold", "schedule")
    evs = prof.events()
    host = {k: [] for k in spans}
    gpu_span = {k: [] for k in spans}
    for e in evs:
        if e.name in spans:
            (host if e.device_type == cpu_t else gpu_span)[e.name].append(
                (e.time_range.start, e.time_range.end))
    steps = host["balancer_step"]
    t0, t1 = min(s for s, _ in steps), max(e for _, e in steps)
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in evs
                 if e.device_type == cuda_t and e.name not in spans
                 and t0 <= e.time_range.start < t1)
    by_kind, by_name, repair_us = {}, {}, []
    for s, e, name in dev:
        k = _kind(name)
        by_kind[k] = by_kind.get(k, 0.0) + (e - s)
        if k == "torch_ops":
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        if k == "repair_kernel":
            repair_us.append(e - s)
    gaps, end, prev = [], t0, "window start"
    for s, e, name in dev:
        if s > end:
            gaps.append((s - end, prev, name))
        if e > end:
            end, prev = e, name
    if t1 > end:
        gaps.append((t1 - end, prev, "window end"))
    gaps.sort(key=lambda g: -g[0])
    iv = [(s, e) for s, e, _ in dev]
    busy = _union_ms(iv, t0, t1)
    step_us = sum(e - s for s, e in steps)
    busy_in_steps = sum(_union_ms(iv, s, e) for s, e in steps)
    phases = {k: dict(
        calls=len(host[k]),
        host_ms=sum(e - s for s, e in host[k]) / len(host[k]) / 1e3,
        device_span_ms=(sum(e - s for s, e in gpu_span[k]) / len(gpu_span[k])
                        / 1e3 if gpu_span[k] else None))
        for k in spans if host[k]}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    ops = sorted(((e.key, e.self_device_time_total) for e in
                  prof.key_averages() if e.self_device_time_total > 0),
                 key=lambda kv: -kv[1])[:8]
    n_rounds = sum(rounds)
    return dict(
        steps=len(steps), window_ms=(t1 - t0) / 1e3,
        device_busy_ms=busy / 1e3,
        device_idle_share=1.0 - busy / (t1 - t0),
        step_ms=step_us / len(steps) / 1e3,
        device_idle_share_in_steps=1.0 - busy_in_steps / step_us,
        device_ms_by_kind={k: v / 1e3 for k, v in by_kind.items()},
        top_torch_kernels_ms=[(n[:80], v / 1e3) for n, v in top],
        top_ops_self_device_ms=[(n[:60], v / 1e3) for n, v in ops],
        longest_idle_gaps=[dict(ms=g / 1e3, after=a[:60], before=b[:60])
                           for g, a, b in gaps[:5]],
        phases=phases, repair_launches=len(repair_us),
        repair_ms_per_launch=(float(np.mean(repair_us)) / 1e3
                              if repair_us else None),
        repair_rounds=n_rounds,
        repair_ms_per_round=(sum(repair_us) / 1e3 / n_rounds
                             if n_rounds else None))


#: steps of the main path's second full segment that are profiled, the step
#: whose repair inputs are kept for main_path_kernel, and the step from
#: which the first scan launch's inputs are kept (the second trickle: a
#: step's bucket covers its releases too, so the scan runs once the full
#: steps' completions have drained); all are left out of the step-latency
#: statistics
PROFILE_FROM, PROFILE_STEPS = 150, 30
CAPTURE_STEP = 200
SCAN_CAPTURE_FROM = 360
#: full steps of the scan-pinned main path, and how many the CPU replays
PINNED_STEPS, PINNED_CPU_STEPS = 40, 10


def main_path_phase(torch, K, TB):
    mem = [MEM_MB] * N_INV
    kw = dict(managed_fraction=0.9, blackbox_fraction=0.1,
              max_batch=MAX_BATCH, action_slots=A)
    plan = schedule()
    gpu = TB.BalancerCore(mem, device=DEVICE, **kw)
    require(gpu.n_pad == N_PAD, f"n_pad {gpu.n_pad}")
    traffic = Traffic(seed=7)
    scan_events, untime = time_launches(TB, "schedule_batch_cuda")
    K.reset_launch_counts()
    gpu_log, times, rounds, prof_rounds = [], {}, [], []
    books_at = prof = box = undo = sbox = sundo = scan_kept_at = None
    rbox = rundo = None
    profiled = range(PROFILE_FROM, PROFILE_FROM + PROFILE_STEPS)
    forced = placed = 0
    t_all = time.perf_counter()
    for k, (name, res, dt) in enumerate(drive(gpu, traffic, plan)):
        gpu_log.append((res.chosen, res.forced, res.rounds))
        if sundo is not None and sbox:  # this step's scan launch was kept
            sundo()
            sundo, scan_kept_at = None, k
        if k in profiled:
            if res.bucket >= 32:
                prof_rounds.append(res.rounds)
        elif k not in (CAPTURE_STEP, scan_kept_at):
            times.setdefault(name, []).append(dt)
        if res.bucket >= 32:
            rounds.append(res.rounds)
        forced += int(res.forced.sum())
        placed += int((res.chosen >= 0).sum())
        require(((res.chosen >= -1) & (res.chosen < N_INV)).all(),
                "decisions in range")
        if k + 1 == CPU_STEPS:
            torch.cuda.synchronize()
            books_at = gpu.books()
        # the loop body runs between steps k and k + 1
        if k + 1 == PROFILE_FROM:
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        elif k + 1 == profiled.stop:
            torch.cuda.synchronize()
            prof.stop()
        elif k + 1 == CAPTURE_STEP:
            box, undo = capture_next(TB, "schedule_batch_repair_cuda")
            rbox, rundo = capture_release(TB)
        elif k == CAPTURE_STEP:
            undo()
            rundo()
        elif k + 1 == SCAN_CAPTURE_FROM:
            sbox, sundo = capture_next(TB, "schedule_batch_cuda")
    wall = time.perf_counter() - t_all
    launches = _launches(K)
    untime()
    torch.cuda.synchronize()
    scan_ms, scan_timed = launch_ms(scan_events)
    full = np.array(times["full"]) * 1e3
    full_placed = sum(int((r[0] >= 0).sum()) for k, ((nm, *_), r) in
                      enumerate(zip(plan, gpu_log))
                      if nm == "full" and k not in profiled
                      and k != CAPTURE_STEP)
    free, _, _ = gpu.books()
    require(np.isfinite(free).all() and free.shape == (N_PAD,), "books")
    summary = dict(
        steps=len(plan), wall_s=wall, placed=placed, forced=forced,
        full_steps_timed=len(full),
        placements_per_s=full_placed / (full.sum() / 1e3),
        step_p50_ms=float(np.percentile(full, 50)),
        step_p99_ms=float(np.percentile(full, 99)),
        trickle_p50_ms=float(np.percentile(np.array(times["trickle"]) * 1e3,
                                           50)),
        mean_repair_rounds=float(np.mean(rounds)), launches=launches,
        scan_ms_per_launch=scan_ms, scan_kept_at_step=scan_kept_at,
        counters=gpu.counters)
    say("main_path", **summary)
    require(launches["scan"] > 0 and launches["repair"] > 0
            and launches["release"] > 0,
            f"every kernel launched on the main path: {launches}")
    require(scan_timed == launches["scan"], "every scan launch was timed")
    require(forced > 0, "the overload burst forced placements")
    profile = device_profile(prof, torch, prof_rounds)
    say("profile", **profile)
    require(profile["repair_launches"] == len(prof_rounds),
            "the profile saw every repair launch of its steps")
    require(box and sbox and rbox, "a repair and a scan launch and a "
                                   "release fold of the main path were kept")

    # the same seed and sequence through the plain path on the CPU
    cpu = TB.BalancerCore(mem, device="cpu", **kw)
    t0 = time.perf_counter()
    mismatches = 0
    for k, (name, res, _) in enumerate(drive(cpu, Traffic(seed=7),
                                             plan[:CPU_STEPS])):
        g = gpu_log[k]
        if not (np.array_equal(res.chosen, g[0])
                and np.array_equal(res.forced, g[1])
                and res.rounds == g[2]):
            mismatches += 1
    cpu_books = cpu.books()
    books_equal = all(np.array_equal(x, y)
                      for x, y in zip(cpu_books, books_at))
    say("cpu_replay", steps=CPU_STEPS, mismatched_steps=mismatches,
        books_equal=books_equal, cpu_s=time.perf_counter() - t0)
    require(mismatches == 0 and books_equal,
            "card and CPU runs agree in decisions, rounds and books")
    return summary, launches, profile, box, sbox, rbox


def scan_pinned_phase(torch, K, TB):
    """The main path with the scan on every bucket: PINNED_STEPS full
    256-row steps of the same traffic through
    `BalancerCore(placement_kernel="scan")`, each scan launch timed with
    CUDA events; the first PINNED_CPU_STEPS replayed on the CPU."""
    mem = [MEM_MB] * N_INV
    kw = dict(managed_fraction=0.9, blackbox_fraction=0.1,
              max_batch=MAX_BATCH, action_slots=A, placement_kernel="scan")
    plan = [("full", MAX_BATCH, False, None)] * PINNED_STEPS
    gpu = TB.BalancerCore(mem, device=DEVICE, **kw)
    events, untime = time_launches(TB, "schedule_batch_cuda")
    K.reset_launch_counts()
    log, step_ms, books_at = [], [], None
    for k, (_, res, dt) in enumerate(drive(gpu, Traffic(seed=7), plan)):
        log.append((res.chosen, res.forced))
        step_ms.append(dt * 1e3)
        require(res.bucket == MAX_BATCH and res.rounds == 0,
                "full steps on the scan")
        if k + 1 == PINNED_CPU_STEPS:
            torch.cuda.synchronize()
            books_at = gpu.books()
    launches = {"scan": K.schedule_batch_cuda.launches,
                "repair": K.schedule_batch_repair_cuda.launches}
    untime()
    torch.cuda.synchronize()
    kernel_ms, timed = launch_ms(events)
    require(launches["scan"] == PINNED_STEPS and launches["repair"] == 0
            and timed == PINNED_STEPS,
            f"the scan alone ran the pinned path: {launches}")
    cpu = TB.BalancerCore(mem, device="cpu", **kw)
    t0 = time.perf_counter()
    mismatches = 0
    for k, (_, res, _) in enumerate(drive(cpu, Traffic(seed=7),
                                          plan[:PINNED_CPU_STEPS])):
        if not (np.array_equal(res.chosen, log[k][0])
                and np.array_equal(res.forced, log[k][1])):
            mismatches += 1
    books_equal = all(np.array_equal(x, y)
                      for x, y in zip(cpu.books(), books_at))
    out = dict(steps=PINNED_STEPS, step_p50_ms=float(np.median(step_ms)),
               launches=launches, kernel_ms_per_launch=kernel_ms,
               kernel_share_of_step=kernel_ms / float(np.median(step_ms)),
               placed=int(sum((c >= 0).sum() for c, _ in log)),
               cpu_replay=dict(steps=PINNED_CPU_STEPS,
                               mismatched_steps=mismatches,
                               books_equal=books_equal,
                               cpu_s=time.perf_counter() - t0))
    say("scan_pinned", **out)
    require(mismatches == 0 and books_equal,
            "scan-pinned card and CPU runs agree in decisions and books")
    return out


# ---------------------------------------------------------------- phase 7
#: the front's traffic: publish_many waves of MAX_BATCH rows, the profiled
#: waves, the 1% flap (down at FLAP_AT, a ping brings it back FLAP_BACK
#: waves later), the trickle steps, and the rate-limited segment
FRONT_WAVES = 80
FRONT_PROFILE_FROM, FRONT_PROFILE_WAVES = 40, 30
FLAP_AT, FLAP_BACK = 10, 6
FRONT_TRICKLE = 20
RATE_WAVES, RATE_LIMIT = 16, 60
#: the pool marks an invoker offline after 10 s without a ping: the fleet
#: pings every invoker again once this many seconds have passed
REPING_S = 3.0
PING_CHUNK = 1000  # pings in flight at once (the health topic keeps 4,096)


def _percentiles(xs):
    xs = np.asarray(xs, float)
    return (float(np.percentile(xs, 50)), float(np.percentile(xs, 99))) \
        if len(xs) else (None, None)


def _time_sends(bal, acc, key):
    """Time the balancer's dispatch sends under acc[key]: the coalescing
    producer's flush (one frame a topic) when it is on, else each awaited
    send."""
    co = getattr(bal.producer, "_co", None)
    if co is not None:
        _time_calls(co, "_flush", acc, key)
    else:
        _time_calls(bal, "send_activation_to_invoker", acc, key)


def _time_calls(obj, name, acc, key):
    """Route obj.name through a wrapper that adds its wall time to
    acc[key] (a host-time split of the front; coroutines are timed from
    call to return)."""
    real = getattr(obj, name)
    acc.setdefault(key, 0.0)
    if asyncio.iscoroutinefunction(real):
        async def timed(*a, **k):
            t = time.perf_counter()
            try:
                return await real(*a, **k)
            finally:
                acc[key] += time.perf_counter() - t
    else:
        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                acc[key] += time.perf_counter() - t
    setattr(obj, name, timed)


class Fleet:
    """`n_inv` simulated invokers of MEM_MB on one in-memory bus. One fleet
    task drains the invoker topics the balancer wrote to (the bus's
    producer notes them), decodes columnar batch frames and plain messages
    as the port's invoker does, and acks each activation `delay` waves
    after it arrived, with its result, through the coalescing producer an
    invoker uses (`maybe_coalesce`: one frame a wave when it is on); pings
    go out in paced rounds. With `echo` every activation is acked as soon
    as it is drained, with its arguments as its result. `wire` counts the
    frames the bus carried and the messages in them, for dispatches and
    for acks. `received_by` counts the activations each invoker received;
    an invoker in `slow` (index -> waves) acks that many waves later than
    the draw (its stragglers' acks, phase 7q)."""

    def __init__(self, seed, echo=False, n_inv=None):
        self.echo = echo
        self.n_inv = N_INV if n_inv is None else n_inv
        from openwhisk_tpu_torch.core import entity as E
        from openwhisk_tpu_torch.messaging import memory as mem
        from openwhisk_tpu_torch.messaging import message as M
        from openwhisk_tpu_torch.messaging.coalesce import maybe_coalesce
        self.E, self.M = E, M
        self.rng = np.random.RandomState(seed)
        fleet = self
        self.touched, self.wake = set(), None
        self.wire = {"dispatch": [0, 0], "ack": [0, 0]}

        def note(topic, msg):
            kind = ("dispatch" if topic.startswith("invoker") else
                    "ack" if topic.startswith("completed") else None)
            if kind is not None:
                aids = getattr(msg, "activation_ids", None)
                fleet.wire[kind][0] += 1
                fleet.wire[kind][1] += 1 if aids is None else len(aids)
            if kind == "dispatch":
                fleet.touched.add(topic)
                fleet.wake.set()

        class Producer(mem.MemoryProducer):
            async def send(self, topic, msg):
                await super().send(topic, msg)
                note(topic, msg)

            async def send_many(self, items):
                await super().send_many(items)
                for topic, _payload, msg in items:
                    note(topic, msg)

        class Bus(mem.MemoryMessagingProvider):
            def get_producer(self):
                return Producer(self.bus)

        self.provider = Bus()
        self.producer = self.provider.get_producer()
        self.ack_producer = maybe_coalesce(self.provider.get_producer())
        self.instances = [E.InvokerInstanceId(i, user_memory=E.MB(MEM_MB))
                          for i in range(self.n_inv)]
        self.consumers = {}
        self.due = {}          # wave -> [ack]
        self.wave = 0
        self.received = 0
        self.received_by = {}
        self.slow = {}
        self.last_ping = 0.0
        self.task = None
        #: a list to keep every drained activation message in, or None
        self.seen = None
        self.host_s = {"fleet_parse_and_ack_build": 0.0}
        _time_calls(self, "ack_due", self.host_s, "fleet_ack_send")
        self.host_s["fleet_ping_send"] = 0.0

    def start(self):
        self.wake = asyncio.Event()
        self.task = asyncio.get_event_loop().create_task(self._drain())

    async def stop(self):
        self.task.cancel()
        await asyncio.gather(self.task, return_exceptions=True)
        await self.ack_producer.close()

    def wire_report(self):
        """Frames the bus carried and messages a frame, for dispatches
        (to invoker topics) and for acks (to completed topics)."""
        return {k: dict(frames=f, messages=m,
                        messages_per_frame=m / f if f else None)
                for k, (f, m) in self.wire.items()}

    async def _drain(self):
        from openwhisk_tpu_torch.messaging.columnar import is_batch_payload
        from openwhisk_tpu_torch.messaging.connector import (decode_batch,
                                                             decode_message)
        E, M = self.E, self.M
        while True:
            await self.wake.wait()
            self.wake.clear()
            topics, self.touched = self.touched, set()
            echoed = []
            t0 = time.perf_counter()
            for topic in topics:
                c = self.consumers.get(topic)
                if c is None:
                    c = self.consumers[topic] = self.provider.get_consumer(
                        topic, topic, max_peek=1 << 16)
                got = await c.peek(1 << 16, timeout=0)
                c.commit()
                inv = self.instances[int(topic[len("invoker"):])]
                msgs = []
                for _, _, _, payload in got:
                    if is_batch_payload(payload):
                        msgs.extend(decode_batch(payload)[1])
                    else:
                        msgs.append(decode_message(M.ActivationMessage.parse,
                                                   payload, "activation"))
                if self.seen is not None:
                    self.seen.extend(msgs)
                for msg in msgs:
                    now = time.time()
                    act = E.WhiskActivation(
                        E.EntityPath(str(msg.user.namespace.name)),
                        msg.action.name, msg.user.subject,
                        msg.activation_id, now, now,
                        E.ActivationResponse.success(
                            msg.content if self.echo else {"ok": True}),
                        duration=1)
                    ack = (f"completed{msg.root_controller_index.as_string}",
                           M.CombinedCompletionAndResultMessage(
                               msg.transid, act, inv))
                    if self.echo:
                        echoed.append(ack)
                    else:
                        self.due.setdefault(
                            self.wave + int(self.rng.randint(1, 9))
                            + self.slow.get(inv.instance, 0),
                            []).append(ack)
                    self.received += 1
                    self.received_by[inv.instance] = \
                        self.received_by.get(inv.instance, 0) + 1
            self.host_s["fleet_parse_and_ack_build"] += \
                time.perf_counter() - t0
            if echoed:
                t0 = time.perf_counter()
                await self._send_acks(echoed)
                self.host_s["fleet_ack_send"] += time.perf_counter() - t0

    async def _send_acks(self, acks):
        """One `send_batch` a topic: a wave of acks is one frame on the
        coalescing producer, one send each on the raw one."""
        by_topic = {}
        for topic, ack in acks:
            by_topic.setdefault(topic, []).append(ack)
        for topic, msgs in by_topic.items():
            await self.ack_producer.send_batch(topic, msgs)

    async def ack_due(self, wave, everything=False):
        """Advance to `wave` and send the acks due by then (all of them
        with `everything`)."""
        self.wave = wave
        keys = sorted(k for k in self.due if everything or k <= wave)
        acks = []
        for k in keys:
            acks.extend(self.due.pop(k))
        await self._send_acks(acks)

    async def ping(self, pool, ids):
        """Ping invokers `ids` through `pool`'s health feed, PING_CHUNK at
        a time, each chunk waited for (pings are handled in order)."""
        t_round = time.monotonic()
        for s in range(0, len(ids), PING_CHUNK):
            chunk = ids[s:s + PING_CHUNK]
            t0 = time.perf_counter()
            for i in chunk:
                await self.producer.send("health",
                                         self.M.PingMessage(self.instances[i]))
            self.host_s["fleet_ping_send"] += time.perf_counter() - t0
            last = chunk[-1]
            while (pool.invokers.get(last) is None
                   or pool.invokers[last].last_ping < t_round):
                require(time.monotonic() - t_round < 60.0,
                        "the pool handled a ping round within 60 s")
                await asyncio.sleep(0.001)
        self.last_ping = time.monotonic()

    async def keep_alive(self, pool):
        if time.monotonic() - self.last_ping > REPING_S:
            await self.ping(pool, list(range(self.n_inv)))


#: the host layers the observatory's samples are filed under: a sample goes
#: to the first of these files found from its leaf frame up; a leaf in the
#: selector is the loop waiting for I/O, any other sample the loop itself
HOST_LAYERS = (
    ("balancer", ("tpu_balancer.py", "base.py", "supervision.py",
                  "flight_recorder.py", "placement.py", "throttle.py",
                  "ring_buffer.py", "placement_cuda.py")),
    ("bus", ("coalesce.py", "columnar.py", "connector.py", "memory.py",
             "message.py", "microbatch.py")),
    ("entitlement", ("entitlement.py", "admission.py")),
    ("api_handler", ("api.py", "invoke.py", "authentication.py",
                     "entities.py", "cache.py", "store.py",
                     "memory_store.py", "activation_store.py",
                     "batcher.py", "activation.py", "action.py")),
    ("aiohttp", ("web_protocol.py", "web_request.py", "web_response.py",
                 "http_parser.py", "http_writer.py", "streams.py",
                 "web_urldispatcher.py", "web_app.py", "web_middlewares.py",
                 "base_protocol.py", "web_server.py", "helpers.py",
                 "payload.py", "web_exceptions.py")),
    ("host_planes", ("hostprof.py", "tracestore.py", "waterfall.py",
                     "tracing.py", "eventlog.py", "logging.py")),
    ("simulated_fleet", ("chip_smoke.py",)),
)


def _host_layer(stack):
    frames = stack.split(";")
    leaf = frames[-1].split(":")[0]
    if leaf == "selectors.py":
        return "loop_waiting_for_io"
    for frame in reversed(frames):
        name = frame.split(":")[0]
        for layer, files in HOST_LAYERS:
            if name in files:
                return layer
    return "event_loop"


def _census():
    from openwhisk_tpu_torch.utils.hostprof import GLOBAL_HOST_OBSERVATORY
    out = {}
    for line in GLOBAL_HOST_OBSERVATORY.collapsed_text().splitlines():
        stack, _, n = line.rpartition(" ")
        out[stack] = int(n)
    return out


def _obs_mark():
    """The host observatory's counters now: raw histograms, and the
    always-on sampler's collapsed stacks."""
    from openwhisk_tpu_torch.utils.hostprof import GLOBAL_HOST_OBSERVATORY
    return GLOBAL_HOST_OBSERVATORY.raw_counts(), _census()


def _obs_delta(mark, invokes, wall_s):
    """What the host observatory counted since `mark`, over `invokes`
    activations and `wall_s` seconds: loop-lag p50/p99 from the lag
    histogram's difference, GC pauses and pause ms by generation, tasks
    created per invoke, serde count, bytes and ms by (hop, direction), and
    the event-loop thread's samples filed by host layer (HOST_LAYERS), as
    shares and as loop ms an invoke."""
    from openwhisk_tpu_torch.utils.hostprof import GLOBAL_HOST_OBSERVATORY
    obs = GLOBAL_HOST_OBSERVATORY
    (raw0, census0), (raw1, census1) = mark, _obs_mark()
    if not raw1["enabled"]:
        return {"enabled": False}
    lag = [b - a for a, b in zip(raw0["lag"]["hist"], raw1["lag"]["hist"])]
    g0, g1 = raw0["gc"], raw1["gc"]
    serde0 = {(h, d): r for h, d, *r in raw0["serde"]}
    serde = []
    for hop, direction, count, nbytes, ns in raw1["serde"]:
        c0, b0, n0 = serde0.get((hop, direction), (0, 0, 0))
        if count > c0:
            serde.append(dict(hop=hop, direction=direction,
                              count=count - c0, bytes=nbytes - b0,
                              ms=(ns - n0) / 1e6))
    tasks = raw1["tasks"]["created"] - raw0["tasks"]["created"]
    layers, samples = {}, 0
    for stack, n in census1.items():
        n -= census0.get(stack, 0)
        if n > 0:
            layer = _host_layer(stack)
            layers[layer] = layers.get(layer, 0) + n
            samples += n
    split = {k: dict(samples=v, share=v / samples,
                     loop_ms_per_invoke=v / samples * wall_s * 1e3
                     / max(1, invokes))
             for k, v in sorted(layers.items(), key=lambda kv: -kv[1])}
    return dict(
        enabled=True, installed=obs.installed,
        loop_lag_ms_p50_p99=[obs._pctl_ms(lag, 0.5), obs._pctl_ms(lag, 0.99)],
        lag_ticks=sum(lag),
        gc_pauses=[b - a for a, b in zip(g0["count"], g1["count"])],
        gc_pause_ms=[(b - a) / 1e3 for a, b in zip(g0["sum_us"],
                                                   g1["sum_us"])],
        gc_overlapping_dispatch=(g1["overlapping_dispatch"]
                                 - g0["overlapping_dispatch"]),
        tasks_created=tasks, tasks_per_invoke=tasks / max(1, invokes),
        serde=serde, loop_samples=samples, loop_split=split)


class ActionMix:
    """Phase 4's Zipf(1.1) mix over 2,000 actions as `(action, message)`
    pairs for the front: one namespace identity per ns, memory 128-2048 MB,
    max_conc 2-16 for a fifth, blackbox for 5%."""

    def __init__(self, seed, ctrl):
        from openwhisk_tpu_torch.core import entity as E
        from openwhisk_tpu_torch.messaging import message as M
        from openwhisk_tpu_torch.utils.transaction import TransactionId
        self.E, self.M, self.Tx, self.ctrl = E, M, TransactionId, ctrl
        mix = Traffic(seed)
        self.rng, self.p = mix.rng, mix.p
        # deployments opt in to these (the defaults cap at 512 MB / 1)
        E.MemoryLimit.MAX = E.MB(2048)
        E.ConcurrencyLimit.MAX = 16
        self.idents = [E.Identity.from_json({
            "subject": f"subject{j}",
            "namespace": {"name": f"ns{j}",
                          "uuid": f"{j:08x}-71f6-4ed5-8c54-816aa4f8c502"},
            "authkey": {"api_key": f"{j:08x}-71f6-4ed5-8c54-816aa4f8c502:"
                                   + "k" * 64},
            "rights": ["ACTIVATE"], "limits": {}}) for j in range(200)]
        self.actions = []
        for k in range(len(mix.p)):
            exe = (E.BlackBoxExec(image="img") if mix.blackbox[k]
                   else E.CodeExec(kind="python:3", code="x"))
            a = E.ExecutableWhiskAction(
                E.EntityPath(f"ns{k % 200}/pkg"), E.EntityName(f"action{k}"),
                exe, limits=E.ActionLimits(
                    E.TimeLimit(60_000), E.MemoryLimit(E.MB(int(mix.mem[k]))),
                    concurrency=E.ConcurrencyLimit(int(mix.maxc[k]))))
            a.rev = E.DocRevision("1-a")
            self.actions.append(a)
        self.count = 0

    def pairs(self, n):
        E = self.E
        out = []
        for k in self.rng.choice(len(self.p), n, p=self.p):
            self.count += 1
            a = self.actions[k]
            out.append((a, self.M.ActivationMessage(
                self.Tx(f"front{self.count}"), a.fully_qualified_name,
                "1-a", self.idents[k % 200], E.ActivationId.generate(),
                self.ctrl, False, {})))
        return out


class Recorder:
    """Wraps a balancer's packed step, idle release fold, slot-axis growth
    and the module's health sets (one device's and the mesh's), keeping
    each call's inputs and the step's output (the smoke's instrumentation:
    the balancer has no such feature)."""

    def __init__(self, bal, TB):
        self.bal, self.TB, self.log = bal, TB, []
        step, rel, grow, health, sharded = (
            bal._packed_fn, bal._release_packed_fn, bal._grow_slots,
            TB.set_health, TB.sharded_set_health)
        self.undo = lambda: (setattr(bal, "_packed_fn", step),
                             setattr(bal, "_release_packed_fn", rel),
                             setattr(bal, "_grow_slots", grow),
                             setattr(TB, "set_health", health),
                             setattr(TB, "sharded_set_health", sharded))
        rate = bal.rate_limit_per_minute is not None

        def grow_slots(new_slots):
            self.log.append(("slots", new_slots))
            return grow(new_slots)

        def packed(*args):
            res = step(*args)
            buf, *rest = args[1:]
            now = float(rest.pop(0)) if rate else None
            self.log.append(("step", buf, now, tuple(rest), res[1]))
            return res

        def release(state, rel_t):
            self.log.append(("release", rel_t))
            return rel(state, rel_t)

        def set_health(state, idx, vals, fn=health):
            self.log.append(("health", list(idx), list(vals)))
            return fn(state, idx, vals)

        bal._packed_fn, bal._release_packed_fn = packed, release
        bal._grow_slots = grow_slots
        TB.set_health = set_health
        TB.sharded_set_health = functools.partial(set_health, fn=sharded)

    def replay(self, books, buckets, P, TB, TT, device="cpu", pair=None):
        """The log through the single-device fused steps on `device` from
        `books` (free, conc [A, N], health) and `buckets`: the plain
        versions by default, or the given (schedule, release) `pair` (on
        the card, the single-device balancer's CUDA pair). Returns (steps
        whose packed output differs, steps, the replayed state)."""
        sched, release, _ = pair or TB._torch_pair(self.bal.placement_kernel)
        rate = buckets is not None
        step = (P.make_fused_admit_step_packed if rate
                else P.make_fused_step_packed)(release, sched)
        rel_fn = P.make_release_packed(release)
        free, conc, health = books
        st = P.placement_state_from_numpy(free, conc.T, health, device)
        bk = TT.TokenBucketState(*(t.to(device).clone() for t in buckets)) \
            if rate else None
        bad = steps = 0
        for ev in self.log:
            if ev[0] == "step":
                _, buf, now, shape, out = ev
                if rate:
                    (st, bk), o = step((st, bk), buf.to(device),
                                       np.float32(now), *shape)
                else:
                    st, o = step(st, buf.to(device), *shape)
                steps += 1
                bad += int(not torch.equal(o.cpu(), out.cpu()))
            elif ev[0] == "release":
                st = rel_fn(st, ev[1].to(device))
            elif ev[0] == "slots":
                conc = torch.zeros((ev[1], st.free_mb.shape[0]),
                                   dtype=torch.int32, device=device)
                conc[:st.conc_free.shape[1]] = st.conc_free.T
                st = P.PlacementState(st.free_mb, conc.T, st.health)
            else:
                st = P.set_health(st, ev[1], ev[2])
        return bad, steps, st


def _planes(bal):
    """The host planes' switches as this balancer runs them."""
    from openwhisk_tpu_torch.utils.hostprof import GLOBAL_HOST_OBSERVATORY
    co = getattr(bal.producer, "_co", None) is not None
    return dict(coalescing=co,
                batch_wire=bool(getattr(bal.producer, "batch_wire", False)),
                batched_ack=bal.batched_ack,
                host_observatory=GLOBAL_HOST_OBSERVATORY.installed,
                flight_recorder=bal.flight_recorder.enabled,
                trace_store=bal.trace_store.enabled)


def _books_np(state):
    return tuple(t.cpu().numpy().copy() for t in (
        state.free_mb, state.conc_free.T, state.health))


async def _drain_front(bal, timeout=120.0):
    """Until every activation is acked and nothing is queued or folding."""
    t0 = time.monotonic()
    while (bal.total_active_activations or bal._inflight_steps
           or bal._pending or bal._releases or bal._readbacks
           or not (bal._flush_task is None or bal._flush_task.done())):
        require(time.monotonic() - t0 < timeout,
                f"front drained within {timeout} s: "
                f"{bal.total_active_activations} active")
        await asyncio.sleep(0.001)


async def _front_run(TB, K, rate_limit, ctrl_id, waves, trickle, profile,
                     flap, setup=None, on_wave=None, kernel="auto",
                     fleet_setup=None, balancer_kw=None):
    """One balancer's run: register the fleet, drive `waves` publish_many
    waves (acks 1-8 waves later; the 1% flap with `flap`; the profiled
    window with `profile`), ack everything, the trickle. `fleet_setup(
    fleet)` runs once the fleet exists, `setup(bal)` before the balancer
    starts, `await on_wave(bal, w)` at the start of each wave; `kernel` is
    the balancer's `placement_kernel`, `balancer_kw` more constructor
    arguments (the fleet mesh's). Returns the run's numbers (with the
    quality plane on, its report and the failures it logged), its
    recorder, (books at the start, bucket state at the start, books at
    the end) and the profiler."""
    from openwhisk_tpu_torch.core import entity as E
    from openwhisk_tpu_torch.controller.loadbalancer.base import (
        HEALTHY, LoadBalancerThrottleException)
    errors, warnings = [], []

    class Log:
        def error(self, _tid, msg, *_):
            errors.append(msg)

        def warn(self, _tid, msg, *_):
            warnings.append(msg)

        def info(self, *_):
            pass

    ctrl = E.ControllerInstanceId(ctrl_id)
    fleet = Fleet(seed=11)
    if fleet_setup is not None:
        fleet_setup(fleet)
    fleet.start()
    bal = TB.TpuBalancer(
        fleet.provider, ctrl, logger=Log(), managed_fraction=0.9,
        blackbox_fraction=0.1, max_batch=MAX_BATCH, action_slots=A,
        initial_pad=64, rate_limit_per_minute=rate_limit,
        placement_kernel=kernel, device=None if DEVICE == "cuda" else DEVICE,
        **(balancer_kw or {}))
    # the early build's warm steps (a worker thread, uncounted launches on
    # dummy books) end before any wrapper or probe of this run is set
    bal._await_kernels()
    _annotate_planes(bal)
    if setup is not None:
        setup(bal)
    await bal.start()
    t0 = time.perf_counter()
    await fleet.ping(bal.supervision, list(range(N_INV)))
    register_s = time.perf_counter() - t0
    require(len(bal._registry) == N_INV and all(bal._healthy)
            and bal.state.free_mb.shape[0] == N_PAD,
            f"fleet registered, pad {bal.state.free_mb.shape[0]}")
    # a step folds at most HEALTH_BATCH of the registration's N_INV health
    # flips, an idle fold all of them: let one run before the traffic
    bal._arm_flush()
    await _drain_front(bal)
    require(not bal._health_updates and bool(bal.state.health[:N_INV].all()),
            "the registration's health flips folded")
    books0 = _books_np(bal.state)
    buckets0 = (None if bal._bucket_state is None else
                tuple(t.clone() for t in bal._bucket_state))
    rec = Recorder(bal, TB)
    # the host-time split of the driven segment (the smoke's wrappers)
    host = fleet.host_s
    for k in host:
        host[k] = 0.0
    for name, key in (("publish_many", "balancer_publish_many"),
                      ("_row_placed", "balancer_fan_out"),
                      ("process_acknowledgement", "balancer_ack"),
                      ("process_acknowledgement_frame", "balancer_ack")):
        _time_calls(bal, name, host, key)
    _time_sends(bal, host, "balancer_send")
    _time_calls(bal.supervision, "on_ping", host, "pool_on_ping")
    # the host observatory on this loop, as a controller installs it
    from openwhisk_tpu_torch.utils.hostprof import GLOBAL_HOST_OBSERVATORY
    obs_owner = GLOBAL_HOST_OBSERVATORY.install(metrics=bal.metrics)
    planes = _planes(bal)
    fleet.wire = {k: [0, 0] for k in fleet.wire}
    obs_mark = _obs_mark()
    fr_filed0 = len(bal.flight_recorder) + bal.flight_recorder.dropped
    mix = ActionMix(seed=7, ctrl=ctrl)
    flapped = [int(i) for i in
               fleet.rng.choice(N_INV, N_INV // 100, replace=False)]
    lat, outs_all, flap_status = [], [], {}
    prof = window = rate_waves = None

    async def ack_everything(wave):
        # the fleet must hold every placed activation before it acks all
        placed = sum(1 for o in outs_all
                     if o.done() and not o.cancelled()
                     and o.exception() is None)
        t0 = time.monotonic()
        while fleet.received < placed:
            require(time.monotonic() - t0 < 60.0,
                    f"the fleet received {fleet.received} of {placed}")
            await asyncio.sleep(0.001)
        await fleet.ack_due(wave, everything=True)
        await _drain_front(bal)

    K.reset_launch_counts()
    t_first = time.perf_counter()
    prev = []
    for w in range(waves):
        await fleet.ack_due(w)
        await fleet.keep_alive(bal.supervision)
        if on_wave is not None:
            await on_wave(bal, w)
        if flap and w == FLAP_AT:
            for i in flapped:
                for _ in range(4):
                    bal.supervision.on_invocation_finished(
                        fleet.instances[i], True, False)
            flap_status["down"] = sum(
                bal.supervision.invokers[i].status != HEALTHY
                for i in flapped)
        if flap and w == FLAP_AT + FLAP_BACK:
            await fleet.ping(bal.supervision, flapped)
            flap_status["back"] = sum(
                bal.supervision.invokers[i].status == HEALTHY
                for i in flapped)
        if profile and w == FRONT_PROFILE_FROM:
            rate_waves = (time.perf_counter() - t_first, w * MAX_BATCH)
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=PROFILE_ACTIVITIES)
            prof.start()
            window = torch.profiler.record_function("front_window")
            window.__enter__()
        t_pub = time.perf_counter()
        outs = bal.publish_many(mix.pairs(MAX_BATCH))
        for o in outs:
            o.add_done_callback(
                lambda f, t=t_pub: lat.append(time.perf_counter() - t))
        outs_all.extend(outs)
        # up to two waves in flight: wait for the one before this
        await asyncio.gather(*prev, return_exceptions=True)
        prev = outs
        if profile and w == FRONT_PROFILE_FROM + FRONT_PROFILE_WAVES - 1:
            await asyncio.gather(*prev, return_exceptions=True)
            torch.cuda.synchronize()
            window.__exit__(None, None, None)
            prof.stop()
    await asyncio.gather(*prev, return_exceptions=True)
    await ack_everything(waves)
    # the trickle once the releases have drained: 1-16 rows a step through
    # publish_many, every second step one serial publish
    for k in range(trickle):
        if k % 2:
            a, msg = mix.pairs(1)[0]
            outs = [asyncio.ensure_future(bal.publish(a, msg))]
        else:
            outs = bal.publish_many(mix.pairs(int(mix.rng.randint(1, 17))))
        outs_all.extend(outs)
        await asyncio.gather(*outs, return_exceptions=True)
        await ack_everything(waves + 1 + k)
    t_last = time.perf_counter()
    launches = {"scan": K.schedule_batch_cuda.launches,
                "repair": K.schedule_batch_repair_cuda.launches}
    host_obs = _obs_delta(obs_mark, len(outs_all), t_last - t_first)
    if obs_owner:
        GLOBAL_HOST_OBSERVATORY.uninstall()
    fr_filed = (len(bal.flight_recorder) + bal.flight_recorder.dropped
                - fr_filed0)
    rec.undo()
    promises, failed, throttled = [], [], 0
    for o in outs_all:
        exc = o.exception()
        if isinstance(exc, LoadBalancerThrottleException):
            throttled += 1
        elif exc is not None:
            failed.append(repr(exc))
        else:
            promises.append(o.result())
    results = await asyncio.gather(*promises, return_exceptions=True)
    # the supervision's own tick twice: it folds the last events, and the
    # anomaly step it enqueues harvests on the next
    ticks_in_run = bal.anomaly.device_ticks
    for _ in range(2):
        bal._telemetry_tick()
        torch.cuda.synchronize()
    planes_rep = dict(_plane_report(bal), ticks_in_run=ticks_in_run)
    books = _books_np(bal.state)
    quality = (bal.quality.quality_report(bal._telemetry_invoker_names())
               if bal.quality.enabled else None)
    summary = dict(
        rate_limit=rate_limit, register_s=register_s, waves=waves,
        trickle_steps=trickle, activations=len(promises),
        throttled=throttled, failed=len(failed), failed_first=failed[:3],
        unresolved=sum(not hasattr(r, "response") for r in results),
        fleet_received=fleet.received,
        active_at_end=bal.total_active_activations,
        activations_per_s=len(promises) / (t_last - t_first),
        placement_ms_p50_p99=[x * 1e3 for x in _percentiles(lat)],
        step_ms_p50_p99=list(_percentiles(bal.step_ms)),
        steps=bal.counters["steps"], launches=launches,
        mean_repair_rounds=(bal.counters["repair_rounds"]
                            / max(1, bal.counters["repair_steps"])),
        rtt_policy=bal.rtt_policy, rtt_ewma_ms=bal._rtt_ewma_ms,
        books_full=bool((books[0][:N_INV] == MEM_MB).all()
                        and not books[1].any() and books[2][:N_INV].all()),
        errors=errors[:3],
        host_s=dict(host, wall=t_last - t_first,
                    other=t_last - t_first - sum(host.values())),
        planes=planes, wire=fleet.wire_report(),
        host_observatory=host_obs, flight_recorder_records=fr_filed,
        device_planes=planes_rep)
    if quality is not None:
        summary["quality"] = quality
        summary["quality_failures"] = [
            w for w in warnings if w.startswith(QUALITY_FAILURES)]
    if flap:
        summary["flap"] = dict(invokers=len(flapped), **flap_status)
    if rate_waves is not None:
        summary["placements_per_s_before_profile"] = \
            rate_waves[1] / rate_waves[0]
    await bal.close()
    await fleet.stop()
    return summary, rec, (books0, buckets0, books), prof


def _window_idle_share(prof, window="front_window"):
    """The device's idle share over the host range `window`."""
    cpu_t, cuda_t = torch.autograd.DeviceType.CPU, \
        torch.autograd.DeviceType.CUDA
    evs = prof.events()
    win = [(e.time_range.start, e.time_range.end) for e in evs
           if e.name == window and e.device_type == cpu_t]
    t0, t1 = win[0]
    dev = [(e.time_range.start, e.time_range.end) for e in evs
           if e.device_type == cuda_t and e.name != window
           and e.name not in PLANE_RANGES]
    busy = _union_ms(dev, t0, t1)
    return dict(window_ms=(t1 - t0) / 1e3, device_busy_ms=busy / 1e3,
                device_idle_share=1.0 - busy / (t1 - t0))


#: the profiler's activities (the CPU rehearsal drops CUDA)
PROFILE_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]


def planes_ab(TB, K):
    """The front at phase 7's traffic (PLANES_AB_WAVES waves a run, no
    trickle, flap or profile) with the three device planes off, then on,
    each run a fresh balancer and fleet: step p50, activations/s and
    placement p50 of each. Records the planes' cost on the card inside one
    call; it claims nothing."""
    import os
    prior = {k: os.environ.get(k) for k in PLANES_OFF}
    runs = []
    try:
        for on in (False, True):
            for k, v in PLANES_OFF.items():
                if on:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            out, _rec, _books, _prof = asyncio.run(_front_run(
                TB, K, None, "0", PLANES_AB_WAVES, 0, profile=False,
                flap=False))
            dp = out["device_planes"]
            row = dict(planes_on=on, activations=out["activations"],
                       activations_per_s=out["activations_per_s"],
                       step_ms_p50=out["step_ms_p50_p99"][0],
                       placement_ms_p50=out["placement_ms_p50_p99"][0],
                       steps=out["steps"], folds=dp.get("folds", 0),
                       anomaly_ticks=dp.get("anomaly_ticks", 0))
            say("planes_ab", **row)
            require(not out["failed"] and not out["unresolved"]
                    and out["active_at_end"] == 0 and out["books_full"],
                    f"planes A/B (on={on}): every activation resolved, "
                    f"books full")
            require(dp["enabled"] == on,
                    f"the A/B leg runs with the planes on={on}: {dp}")
            if on:
                _require_planes(dp, out["activations"], "planes A/B")
            runs.append(row)
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return runs


def front_phase(torch, P, K, TB):
    """Phase 7: the front at full width, its checks and its CPU replay."""
    from openwhisk_tpu_torch.ops import throttle as TT
    res = {}
    for label, rate, waves, trickle, profile in (
            ("main", None, FRONT_WAVES, FRONT_TRICKLE, True),
            ("rate_limited", RATE_LIMIT, RATE_WAVES, 0, False)):
        t0 = time.perf_counter()
        out, rec, (books0, buckets0, books), prof = asyncio.run(_front_run(
            TB, K, rate, "0" if label == "main" else "1", waves, trickle,
            profile=profile, flap=profile))
        if prof is not None:
            out["profile"] = _window_idle_share(prof)
            out["device_planes"]["profile_window"] = _device_ms(
                prof, PLANE_RANGES)
        t1 = time.perf_counter()
        bad, steps, st = rec.replay(books0, buckets0, P, TB, TT)
        replay_books = _books_np(st)
        books_equal = all(np.array_equal(x, y)
                          for x, y in zip(books, replay_books))
        out["cpu_replay"] = dict(steps=steps, events=len(rec.log),
                                 mismatched_steps=bad,
                                 books_equal=books_equal,
                                 cpu_s=time.perf_counter() - t1)
        out["run_s"] = t1 - t0
        say("front", segment=label, **out)
        require(not out["failed"] and not out["unresolved"]
                and not out["errors"],
                f"front {label}: every activation resolved")
        require(out["active_at_end"] == 0 and out["books_full"],
                f"front {label}: nothing active, books at full capacity")
        require(bad == 0 and books_equal,
                f"front {label}: card and CPU replay agree")
        require(all(out["planes"].values()),
                f"front {label}: the host planes at their defaults: "
                f"{out['planes']}")
        require(out["wire"]["ack"]["frames"] < out["wire"]["ack"]["messages"]
                and out["flight_recorder_records"] > 0
                and out["host_observatory"]["lag_ticks"] > 0,
                f"front {label}: acks went out in batch frames, the flight "
                f"recorder filed, the observatory ticked")
        _require_planes(out["device_planes"], out["activations"],
                        f"front {label}")
        if rate is None:
            require(out["launches"]["scan"] > 0
                    and out["launches"]["repair"] > 0,
                    f"both kernels launched on the front: {out['launches']}")
            require(out["flap"]["down"] == out["flap"]["invokers"]
                    and out["flap"]["back"] == out["flap"]["invokers"],
                    f"the 1% flap went down and came back: {out['flap']}")
        else:
            require(out["throttled"] > 0, "rows throttled")
            require(out["launches"]["repair"] > 0,
                    f"the repair kernel ran: {out['launches']}")
        res[label] = out
    return res


# --------------------------------------------------------------- phase 7q
#: the quality phase: (a) phase 7's traffic with the quality plane on
#: (the shadow every Q_EVERY batches) and the journal attached, Q_WAVES
#: waves and a Q_TRICKLE-step trickle; at wave Q_SLOW_AT the Q_SLOW
#: invokers that have received the most start acking Q_SLOW_WAVES waves
#: late (stragglers), and the supervision's tick also runs every
#: Q_TICK_EVERY waves from then on; (b) the scan-pinned balancer over
#: Q_PINNED_WAVES waves, the shadow every Q_PINNED_EVERY; (c) 8b's
#: assembly over Q_HTTP_INVOKES invokes and a Q_HTTP_TRICKLE trickle
Q_WAVES, Q_TRICKLE, Q_EVERY = 40, 6, 4
Q_SLOW, Q_SLOW_AT, Q_SLOW_WAVES, Q_TICK_EVERY = 4, 4, 16, 2
Q_PINNED_WAVES, Q_PINNED_EVERY = 10, 2
Q_HTTP_INVOKES, Q_HTTP_TRICKLE = 300, 20
QUALITY_ON = "CONFIG_whisk_placementQuality_enabled"
QUALITY_EVERY = "CONFIG_whisk_placementQuality_shadowEveryN"
#: the quality plane's /metrics families
QUALITY_FAMILIES = ("openwhisk_loadbalancer_placement_regret",
                    "openwhisk_loadbalancer_decision_divergence_total",
                    "openwhisk_loadbalancer_fleet_imbalance")
#: the warnings of a quality-plane failure that the balancer swallows
QUALITY_FAILURES = ("shadow step failed", "quality step failed",
                    "quality summary failed")
#: the scorer's float tolerance against the NumPy twin (reduction order)
Q_RTOL, Q_ATOL = 1e-5, 1e-4


@contextlib.contextmanager
def _environ(values):
    import os
    prior = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class QualityProbe:
    """Wraps a balancer's shadow pass, its quality step and the kernel
    wrapper `attr` (the smoke's instrumentation): every shadow pass and
    scored batch is noted with whether the penalty held a flag (the
    balancer's host copy: no device read), and the first pass, scored
    batch and penalized launch that `want(flagged)` accepts are kept:
    copies of their inputs and outputs. The first penalized launch below
    the repair's bucket (`REPAIR_MIN_BATCH` rows) is kept too, whatever
    its penalty ("kernel_small")."""

    def __init__(self, bal, TB, attr, want):
        self.bal, self.TB, self.attr = bal, TB, attr
        self.passes, self.scored, self.kept = [], [], {}
        shadow, qstep, kernel = bal._shadow_fn, bal._quality_step, \
            getattr(TB, attr)
        self.undo = lambda: (setattr(bal, "_shadow_fn", shadow),
                             setattr(bal, "_quality_step", qstep),
                             setattr(TB, attr, kernel))

        def flagged():
            return bool(bal._shadow_penalty_np.any())

        def shadow_pass(state, buf, penalty, *shape, scratch=None):
            keep = "shadow" not in self.kept and want(flagged())
            books = tuple(t.clone() for t in state) if keep else None
            out = shadow(state, buf, penalty, *shape, scratch=scratch)
            self.passes.append(flagged())
            if keep:
                self.kept["shadow"] = dict(
                    books=books, buf=buf.clone(), penalty=penalty.clone(),
                    shape=shape, out=out.clone())
            return out

        def quality_step(req, out, shadow_out):
            keep = ("scorer" not in self.kept and shadow_out is not None
                    and want(flagged()))
            st, qs = bal.state, bal.quality._qstate
            if keep:
                inputs = (st.free_mb.clone(), st.conc_free.T.clone().T,
                          st.health.clone(), bal._quality_ewma.clone(),
                          bal._quality_caps.clone(), req.clone(),
                          out.clone(), shadow_out.clone())
            summary = qstep(req, out, shadow_out)
            self.scored.append((summary, shadow_out is not None, flagged()))
            if keep:
                self.kept["scorer"] = dict(inputs=inputs, before=qs,
                                           after=bal.quality._qstate,
                                           summary=summary.clone())
            return summary

        def keep_launch(key, state, batch, penalty):
            self.kept[key] = dict(
                state=tuple(t.clone() for t in state),
                batch=type(batch)(*(c.clone() for c in batch)),
                penalty=penalty.clone())

        def launch(state, batch, penalty=None):
            if penalty is not None:
                if "kernel" not in self.kept and want(flagged()):
                    keep_launch("kernel", state, batch, penalty)
                if ("kernel_small" not in self.kept
                        and batch.valid.shape[0] < TB.REPAIR_MIN_BATCH):
                    keep_launch("kernel_small", state, batch, penalty)
            return kernel(state, batch, penalty)

        bal._shadow_fn, bal._quality_step = shadow_pass, quality_step
        setattr(TB, attr, launch)


def quality_kernel(kind, box, pen, torch, P, K):
    """A penalized launch kept on a quality path: the kernel against the
    plain version with `pen` and with no penalty on the same batch, each
    timed with CUDA events, with the penalized work's bound."""
    kfn, pfn = ((K.schedule_batch_cuda, P.schedule_batch) if kind == "scan"
                else (K.schedule_batch_repair_cuda, P.schedule_batch_repair))
    free0, conc0, health = box["state"]
    batch = box["batch"]
    work = P.PlacementState(free0.clone(), conc0.clone(), health)
    std = K.to_transposed(P.PlacementState(free0, conc0, health))

    def restore():
        work.free_mb.copy_(free0)
        work.conc_free.copy_(conc0)

    out = dict(B=int(batch.valid.shape[0]),
               valid_rows=int(batch.valid.sum()),
               penalty_flags=int(pen.sum()))
    for label, p in (("penalized", pen), ("unpenalized", None)):
        err, rounds, _ = compare(kind, std, batch, p, P, K, torch)
        require(err == 0, f"quality {kind} ({label}) differs from plain "
                          f"by {err}")
        row = dict(max_abs_err=err, ms=time_ms(
            lambda: kfn(work, batch, p), restore, torch, reps=10))
        if kind == "repair":
            row["rounds"] = rounds
        out[label] = row
    nbytes, ops, _ = work_bytes_ops(kind, std, batch, pen, P)
    bound_ms, bound_by = bound(nbytes, ops)
    out["penalized"].update(
        bytes=nbytes, key_evals=ops, bound_ms=bound_ms, bound_by=bound_by,
        plain_ms=time_ms(lambda: pfn(K.to_transposed(work), batch, pen),
                         restore, torch, reps=3))
    return out


def _kept_shadow(kept, kernel, P, TB, torch):
    """The kept shadow pass again through the plain shadow step (plain
    torch ops on the card, the balancer's release fold, the same inputs):
    its vector against the card's. Then the card's pass (`kernel` is the
    balancer's placement_kernel) and its book copy alone, timed on the
    same inputs. Returns the line's numbers."""
    books = P.PlacementState(*kept["books"])
    R, H, B = kept["shape"]
    _, release, resolved = TB._torch_pair(kernel)
    shadow = P.make_shadow_step_packed(
        release, TB.penalized_schedule(torch.device(DEVICE), resolved))
    plain = P.make_shadow_step_packed(
        release, TB.penalized_schedule(torch.device("cpu"), resolved))
    want = plain(books, kept["buf"], kept["penalty"], R, H, B)
    torch.cuda.synchronize()
    exact = torch.equal(want, kept["out"])
    scratch = P.empty_books_like(books)
    pass_ms = time_ms(lambda: shadow(books, kept["buf"], kept["penalty"],
                                     R, H, B, scratch=scratch),
                      lambda: None, torch, reps=10)
    copy_ms = time_ms(lambda: P.shadow_books(books, scratch), lambda: None,
                      torch, reps=10)
    copy_bytes = sum(t.numel() * t.element_size() for t in books)
    return dict(R=R, H=H, B=B, penalty_flags=int(kept["penalty"].sum()),
                plain_exact=exact, pass_ms=pass_ms, book_copy_ms=copy_ms,
                book_copy_bytes=copy_bytes,
                book_copy_bound_ms=2 * copy_bytes / HBM_BYTES_S * 1e3)


def _kept_scorer(kept, step, Q, torch):
    """The kept scored batch's delta and summary row against
    `quality_step_np` from the same state (integers exact, floats within
    Q_RTOL / Q_ATOL); the scorer
    once under the sync debug mode (no host sync), then its device ms
    (CUDA events) and host enqueue ms a batch."""
    free, conc, health, ewma, caps, req, out, sh = kept["inputs"]
    host = [t.cpu().numpy() for t in kept["inputs"]]
    want, want_summary = Q.quality_step_np(
        Q.host_state(kept["before"]), *host)
    got = Q.host_state(kept["after"])
    ints = all(np.array_equal(getattr(got, k), getattr(want, k))
               for k in ("regret_hist", "counters", "inv_divergence"))
    err = float(np.max(np.abs(got.inv_regret_ms - want.inv_regret_ms)))
    summary = kept["summary"].cpu().numpy()
    floats = (np.allclose(got.inv_regret_ms, want.inv_regret_ms,
                          rtol=Q_RTOL, atol=Q_ATOL)
              and np.allclose(summary, want_summary, rtol=Q_RTOL,
                              atol=Q_ATOL))
    args = (kept["before"], free, conc, health, ewma, caps, req, out, sh)
    step(*args)  # the first call copies the bucket bounds over
    torch.cuda.synchronize()
    _sync_debug(torch, lambda: step(*args))  # raises on a host sync
    device_ms = time_ms(lambda: step(*args), lambda: None, torch, reps=20)
    enqueue = []
    for _ in range(20):
        t = time.perf_counter()
        step(*args)
        enqueue.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return dict(ints_exact=ints, floats_within=floats,
                inv_regret_max_abs_err=err,
                summary_max_abs_err=float(np.max(np.abs(
                    summary.astype(np.float64) - want_summary))),
                rtol=Q_RTOL, atol=Q_ATOL,
                device_ms=device_ms, host_enqueue_ms=float(np.median(enqueue)),
                divergent_rows=int(want_summary[Q.S_DIVERGENT]))


def _quality_run(TB, K, label, waves, trickle, every, kernel, want,
                 setup=None, on_wave=None, fleet_setup=None):
    """One `_front_run` with the quality plane on and a probe attached:
    (the run's summary, the final books, the probe, launches, penalized
    launches, the quality families on the balancer's metrics page)."""
    box = {}

    def setup_all(bal):
        if setup is not None:
            setup(bal)
        box["probe"] = QualityProbe(bal, TB, attr, want)
        real_close = bal.close

        async def close():
            text = bal.metrics.prometheus_text()
            box["families"] = [f for f in QUALITY_FAMILIES
                               if f"# TYPE {f} " in text]
            await real_close()
        bal.close = close

    attr = ("schedule_batch_cuda" if kernel == "scan"
            else "schedule_batch_repair_cuda")
    with _environ({QUALITY_ON: "true", QUALITY_EVERY: str(every)}):
        out, _rec, (_b0, _bk0, books), _prof = asyncio.run(_front_run(
            TB, K, None, "0", waves, trickle, profile=False, flap=False,
            setup=setup_all, on_wave=on_wave, kernel=kernel,
            fleet_setup=fleet_setup))
    probe = box["probe"]
    probe.undo()
    launches = {"scan": K.schedule_batch_cuda.launches,
                "repair": K.schedule_batch_repair_cuda.launches}
    penalized = {"scan": K.schedule_batch_cuda.penalized_launches,
                 "repair": K.schedule_batch_repair_cuda.penalized_launches}
    q = out["quality"]
    require(not out["failed"] and not out["unresolved"] and not out["errors"]
            and out["active_at_end"] == 0 and out["books_full"],
            f"quality {label}: every activation resolved, books full: "
            f"{out['failed_first']} {out['errors']}")
    require(not out["quality_failures"]
            and q["batches"] == out["steps"]
            and q["shadow_batches"] == out["steps"] // every,
            f"quality {label}: every step scored, every {every}th shadowed, "
            f"no failure swallowed: batches {q['batches']}, shadow "
            f"{q['shadow_batches']}, steps {out['steps']}, "
            f"{out['quality_failures'][:3]}")
    return out, books, probe, launches, penalized, box["families"]


async def _admin_quality(bal, port):
    """7q(c): `/admin/placement/quality`, `?raw=1` and `/metrics` of the
    card-backed controller once its run drained."""
    import aiohttp
    from openwhisk_tpu_torch import standalone as S
    url = f"http://127.0.0.1:{port}"
    got = {}
    async with aiohttp.ClientSession(
            auth=aiohttp.BasicAuth(S.GUEST_UUID, S.GUEST_KEY)) as s:
        for path in ("/admin/placement/quality",
                     "/admin/placement/quality?raw=1"):
            async with s.get(url + path) as r:
                got[path] = (r.status, await r.json())
        async with s.get(url + "/metrics") as r:
            text = await r.text()
    (st, rep), (raw_st, raw) = (got["/admin/placement/quality"],
                                got["/admin/placement/quality?raw=1"])
    return dict(status=st, raw_status=raw_st, counters=rep.get("counters"),
                raw_counters=raw.get("counters"),
                batches=rep.get("batches"),
                shadow_batches=rep.get("shadow_batches"),
                shadow_every_n=rep.get("config", {}).get("shadow_every_n"),
                divergent_rows=rep.get("divergent_rows"),
                kernel=rep.get("kernel"),
                families=[f for f in QUALITY_FAMILIES
                          if f"# TYPE {f} " in text],
                steps=bal.counters["steps"])


def quality_phase(torch, P, K, TB, front):
    """Phase 7q: the placement quality plane and its shadow pass."""
    import shutil
    import tempfile
    from openwhisk_tpu_torch.controller.loadbalancer import journal as JN
    from openwhisk_tpu_torch.controller.loadbalancer import timetravel as TT
    from openwhisk_tpu_torch.ops import decision_quality as Q
    work = tempfile.mkdtemp(prefix="chip-smoke-quality-")
    try:
        return _quality_phase(torch, P, K, TB, front, JN, TT, Q, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _quality_phase(torch, P, K, TB, front, JN, TT, Q, work):
    import os
    t0 = time.perf_counter()
    # (a) "auto": the journal on, stragglers through their acks
    jdir = os.path.join(work, "wal")
    journal = JN.PlacementJournal(jdir)
    box = {}

    def fleet_setup(fleet):
        box["fleet"] = fleet

    async def on_wave(bal, w):
        fleet = box["fleet"]
        if w == Q_SLOW_AT:
            by = fleet.received_by
            box["slow"] = sorted(by, key=by.get, reverse=True)[:Q_SLOW]
            fleet.slow = {i: Q_SLOW_WAVES for i in box["slow"]}
        elif w > Q_SLOW_AT and w % Q_TICK_EVERY == 0:
            bal._telemetry_tick()

    out, books, probe, launches, penalized, families = _quality_run(
        TB, K, "auto", Q_WAVES, Q_TRICKLE, Q_EVERY, "auto", bool,
        setup=lambda bal: bal.attach_journal(journal), on_wave=on_wave,
        fleet_setup=fleet_setup)
    journal.close()
    live_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    flagged_passes = sum(probe.passes)
    divergent = {True: 0, False: 0}
    for summary, shadowed, flagged in probe.scored:
        if shadowed:
            divergent[flagged] += int(summary[Q.S_DIVERGENT])
    require(penalized["repair"] > 0 and penalized["scan"] == 0,
            f"quality auto: the shadow launched the penalized repair: "
            f"{penalized}")
    require(flagged_passes > 0 and divergent[True] > 0,
            f"quality auto: the stragglers {box['slow']} were flagged and "
            f"moved the shadow: {flagged_passes} flagged passes, divergent "
            f"rows {divergent}")
    require(set(families) == set(QUALITY_FAMILIES),
            f"quality auto: the plane's /metrics families: {families}")
    require(all(k in probe.kept for k in ("shadow", "scorer", "kernel",
                                          "kernel_small")),
            f"quality auto: a flagged pass, scored batch and launch, and a "
            f"launch below 32 rows kept: {sorted(probe.kept)}")
    a_pen = probe.kept["kernel"]["penalty"]

    t1 = time.perf_counter()

    async def cpu_replay():
        bal = TT.make_offline_balancer(device="cpu")
        st = bal.replay_journal(JN.PlacementJournal(jdir).records(0))
        eq = _same_books(bal, books)
        await bal.close()
        return st, eq

    cst, cpu_equal = asyncio.run(cpu_replay())
    cpu_s = time.perf_counter() - t1
    require(cpu_equal and cst["parity_mismatches"] == 0
            and cst["batches"] >= Q_WAVES,
            f"quality auto: the journal replays on the CPU to the card's "
            f"decisions and books (the shadow wrote nothing live): {cst}")
    shadow = _kept_shadow(probe.kept["shadow"], "auto", P, TB, torch)
    require(shadow["plain_exact"] and shadow["penalty_flags"] > 0,
            f"quality auto: the kept flagged shadow pass is bit-exact with "
            f"the plain shadow step: {shadow}")
    scorer = _kept_scorer(probe.kept["scorer"],
                          Q.make_quality_step(out["quality"]["config"][
                              "buckets"]), Q, torch)
    require(scorer["ints_exact"] and scorer["floats_within"],
            f"quality auto: the kept batch's score against the NumPy twin: "
            f"{scorer}")
    kern = quality_kernel("repair", probe.kept["kernel"], a_pen, torch, P, K)
    # the trickle's shadow pass runs the penalized repair below 32 rows:
    # that launch's books and batch, held with the flagged penalty
    small = quality_kernel("repair", probe.kept["kernel_small"], a_pen,
                           torch, P, K)
    require(small["B"] < TB.REPAIR_MIN_BATCH and small["penalty_flags"] > 0,
            f"quality auto: the kept trickle launch: {small}")
    auto = dict(
        waves=Q_WAVES, trickle_steps=Q_TRICKLE, shadow_every_n=Q_EVERY,
        slow_invokers=box["slow"], slow_waves=Q_SLOW_WAVES,
        steps=out["steps"], activations=out["activations"],
        quality={k: out["quality"][k] for k in (
            "batches", "shadow_batches", "rows", "divergent_rows",
            "shadow_rows", "divergence_ratio", "regret_sum_ms",
            "regret_p99_le_ms", "fleet_imbalance_cov", "counters")},
        shadow_passes=len(probe.passes), flagged_passes=flagged_passes,
        divergent_rows_flagged=divergent[True],
        divergent_rows_unflagged=divergent[False],
        launches=launches, penalized_launches=penalized,
        families=families, shadow=shadow, scorer=scorer, kernel=kern,
        kernel_small=small,
        step_ms_p50_plane_on=out["step_ms_p50_p99"][0],
        step_ms_p50_phase7=front["main"]["step_ms_p50_p99"][0],
        activations_per_s=out["activations_per_s"],
        cpu_replay=dict(backend="cpu", batches=cst["batches"],
                        parity_mismatches=cst["parity_mismatches"],
                        books_equal=cpu_equal, s=cpu_s),
        live_s=live_s)
    say("quality", segment="auto", **auto)

    # (b) scan-pinned, (a)'s straggler flags set in the anomaly plane's
    # scores at every wave (a tick of its own would replace them)
    t2 = time.perf_counter()
    flags = a_pen.cpu().numpy().astype(np.float32)

    async def flag_stragglers(bal, _w):
        from openwhisk_tpu_torch.ops.anomaly import (N_SCORE_ROWS,
                                                     S_STRAGGLER_FLAG)
        old, n = bal.anomaly._scores, bal._n_pad
        sc = np.zeros((N_SCORE_ROWS, n), np.float32)
        if old is not None:  # harvested at the plane's own width
            k = min(n, old.shape[1])
            sc[:, :k] = old[:, :k]
        sc[S_STRAGGLER_FLAG] = flags[:n]
        bal.anomaly._scores = sc
        bal._refresh_quality_signals()

    bout, _bbooks, bprobe, blaunches, bpen, _ = _quality_run(
        TB, K, "scan", Q_PINNED_WAVES, 0, Q_PINNED_EVERY, "scan", bool,
        on_wave=flag_stragglers)
    torch.cuda.synchronize()
    bdiv = sum(int(summary[Q.S_DIVERGENT]) for summary, shadowed, flagged
               in bprobe.scored if shadowed and flagged)
    require(bpen["scan"] > 0 and blaunches["repair"] == 0,
            f"quality scan: the shadow launched the penalized scan: "
            f"{blaunches} {bpen}")
    require(all(k in bprobe.kept for k in ("shadow", "kernel"))
            and bdiv > 0,
            f"quality scan: (a)'s flags moved the shadow: divergent rows "
            f"{bdiv}, kept {sorted(bprobe.kept)}")
    bshadow = _kept_shadow(bprobe.kept["shadow"], "scan", P, TB, torch)
    require(bshadow["plain_exact"] and bshadow["penalty_flags"] > 0,
            f"quality scan: the kept flagged shadow pass is bit-exact with "
            f"the plain shadow step: {bshadow}")
    bkern = quality_kernel("scan", bprobe.kept["kernel"],
                           bprobe.kept["kernel"]["penalty"], torch, P, K)
    pinned = dict(waves=Q_PINNED_WAVES, shadow_every_n=Q_PINNED_EVERY,
                  steps=bout["steps"],
                  quality={k: bout["quality"][k] for k in (
                      "batches", "shadow_batches", "rows",
                      "divergent_rows")},
                  divergent_rows_flagged=bdiv,
                  launches=blaunches, penalized_launches=bpen,
                  shadow=bshadow, kernel=bkern,
                  step_ms_p50_plane_on=bout["step_ms_p50_p99"][0],
                  run_s=time.perf_counter() - t2)
    say("quality", segment="scan_pinned", **pinned)

    # (c) one card-backed controller over HTTP
    t3 = time.perf_counter()
    with _environ({QUALITY_ON: "true"}):
        hout, _rec, _b0, _b1 = asyncio.run(_http_fleet_run(
            TB, K, invokes=Q_HTTP_INVOKES, trickle=Q_HTTP_TRICKLE,
            full=False, admin=_admin_quality))
    hpen = {"scan": K.schedule_batch_cuda.penalized_launches,
            "repair": K.schedule_batch_repair_cuda.penalized_launches}
    adm = hout["admin"]
    n = Q_HTTP_INVOKES + Q_HTTP_TRICKLE
    require(hout["n_bad"] == 0, f"quality http: every invoke 200 with its "
            f"echo: {hout['bad_first']}")
    require(adm["status"] == adm["raw_status"] == 200
            and adm["kernel"] == "device"
            and adm["counters"]["rows"] == adm["counters"]["placed"] == n
            and adm["raw_counters"][0] == n
            and adm["batches"] == adm["steps"]
            and adm["shadow_batches"] == adm["steps"] // adm["shadow_every_n"]
            and hpen["repair"] > 0 and not hout["quality_failures"],
            f"quality http: /admin/placement/quality counts every invoke, "
            f"every step scored, every {adm['shadow_every_n']}th shadowed "
            f"(penalized launches {hpen}), no failure swallowed "
            f"{hout['quality_failures'][:3]}: {adm}")
    want_families = set(QUALITY_FAMILIES) - (
        set() if adm["divergent_rows"] else {QUALITY_FAMILIES[1]})
    require(set(adm["families"]) == want_families,
            f"quality http: /metrics carries the plane's families: {adm}")
    http = dict(invokes=n, invokes_per_s=hout["invokes_per_s"],
                http_ms_p50_p99=hout["http_ms_p50_p99_concurrent"],
                launches=hout["launches"], penalized_launches=hpen,
                run_s=time.perf_counter() - t3,
                **adm)
    say("quality", segment="http", **http)
    res = dict(auto=auto, scan_pinned=pinned, http=http,
               seconds=time.perf_counter() - t0)
    res["launches"] = {k: auto["launches"][k] + blaunches[k]
                       + hout["launches"][k] for k in ("scan", "repair")}
    res["penalized_launches"] = {k: penalized[k] + bpen[k] + hpen[k]
                                 for k in ("scan", "repair")}
    return res


# --------------------------------------------------------------- phase 7m
#: the mesh phase, every shard of an S-shard fleet mesh on the card: (a) the
#: sharded ops against the single-device kernels at phase 3's geometry and
#: batch widths MESH_B (the families at each); (b) phase 7's front through a mesh balancer and a
#: single-device one, MESH_WAVES waves and a MESH_TRICKLE trickle each, (c)
#: with the quality plane on in both: a shadow pass every MESH_Q_EVERY
#: batches, MESH_Q_FLAGGED invokers flagged as stragglers; (d)
#: MESH_WIDE_STEPS steps of MAX_BATCH rows at N = 262,144 (MESH_WIDE_INV
#: invokers) and A = MESH_WIDE_A
MESH_S = 8
MESH_B = {16: FAMILIES, 256: ("memory", "container", "oob")}
MESH_WAVES, MESH_TRICKLE = 20, 6
MESH_Q_EVERY, MESH_Q_FLAGGED = 4, 100
MESH_WIDE_INV, MESH_WIDE_A, MESH_WIDE_STEPS = 140_000, 1_024, 4


def _cuda_events(prof):
    """Device-side events (kernels and copies) in a torch.profiler run."""
    cuda_t = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.events() if e.device_type == cuda_t)


def _launch_census(fn):
    """fn() once under torch.profiler: (its result, device events)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=PROFILE_ACTIVITIES) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, _cuda_events(prof)


def _max_err(pairs):
    return max(int((x.long() - y.long()).abs().max()) for x, y in pairs)


def _mesh_ops(torch, P, K, TB, FM, SS, mesh):
    """7m(a): for each family and width, the sharded scan, the sharded
    repair (plain and penalized) and the owner-masked release vector
    against the single-device CUDA kernels (and the plain release vector)
    on copies of the same books: decisions, rounds and books. Then one
    fused step at MAX_BATCH rows on the mesh and on one device: its
    output and books, its device events (profiler), host syncs and time."""
    err, rounds_equal, mesh_launches, n_cases = 0, True, 0, 0
    rounds = {}
    t0 = time.perf_counter()
    sched_scan = SS.make_sharded_schedule(mesh)
    sched_rep = FM.make_fleet_repair_schedule(mesh)
    sched_pen = FM.make_fleet_repair_schedule(mesh, penalized=True)
    rel_vec = FM.make_fleet_release_vector(mesh)
    for b, families in MESH_B.items():
        for fam in families:
            state, batch, pen = make_case(fam, b, 700 + b, torch, P)
            for kind in ("scan", "repair", "repair_penalized"):
                p = pen if kind == "repair_penalized" else None
                ks = clone_state(P, state)
                kern = (K.schedule_batch_cuda if kind == "scan"
                        else K.schedule_batch_repair_cuda)
                kout = kern(K.to_transposed(ks), batch, p)
                sh = SS.shard_state(state, mesh)
                K.reset_launch_counts()
                mout = (sched_scan(sh, batch) if kind == "scan" else
                        sched_rep(sh, batch) if p is None else
                        sched_pen(sh, batch, p))
                torch.cuda.synchronize()
                mesh_launches += (K.schedule_batch_cuda.launches
                                  + K.schedule_batch_repair_cuda.launches)
                g = SS.gather_state(sh)
                pairs = [(kout[1], mout[1]), (kout[2].int(), mout[2].int()),
                         (ks.free_mb, g.free_mb), (ks.conc_free, g.conc_free)]
                err = max(err, _max_err(pairs))
                if kind != "scan":
                    rounds_equal &= int(kout[3]) == int(mout[3])
                    rounds[f"{kind}_B{b}_{fam}"] = int(mout[3])
                # the release vector returns what placed, on both (rows
                # with a slot in range: the release has no dropped write)
                chosen = kout[1]
                rel = (chosen.clamp_min(0), batch.conc_slot.clamp_max(A - 1),
                       batch.need_mb, batch.max_conc,
                       (chosen >= 0) & (batch.conc_slot < A))
                P.release_batch_vector(ks, *rel)
                rel_vec(sh, *rel)
                g = SS.gather_state(sh)
                err = max(err, _max_err([(ks.free_mb, g.free_mb),
                                         (ks.conc_free, g.conc_free)]))
                n_cases += 1
    require(err == 0 and rounds_equal and mesh_launches == 0,
            f"7m(a): the sharded ops equal the single-device kernels "
            f"(max_abs_err {err}, rounds equal {rounds_equal}) and launch "
            f"no placement kernel ({mesh_launches})")

    cases_s = time.perf_counter() - t0
    # one fused step at MAX_BATCH rows: releases of a placed batch, no
    # health flips, a fresh batch, on the mesh and on one device
    t0 = time.perf_counter()
    state, batch, _pen = make_case("memory", MAX_BATCH, 990, torch, P)
    placed = clone_state(P, state)
    chosen = K.schedule_batch_repair_cuda(K.to_transposed(placed), batch)[1]
    torch.cuda.synchronize()
    r, h, b = MAX_BATCH, 64, MAX_BATCH
    rel = torch.stack([chosen.clamp_min(0), batch.conc_slot, batch.need_mb,
                       batch.max_conc, (chosen >= 0).int()]).int()
    _s2, batch2, _p2 = make_case("memory", MAX_BATCH, 991, torch, P)
    req = torch.stack([c.int() for c in batch2])
    buf = torch.cat([rel.reshape(-1), torch.zeros(3 * h, dtype=torch.int32,
                                                  device=DEVICE),
                     req.reshape(-1)])
    sched, release, _ = TB._cuda_pair("auto")
    one = P.make_fused_step_packed(release, sched)
    sched, release, _ = FM.fleet_pair(mesh, "auto")
    fused = FM.make_fleet_fused_step_packed(mesh, release, sched)
    box = {}

    def reset():
        box["one"] = clone_state(P, placed)
        box["mesh"] = SS.shard_state(placed, mesh)

    reset()
    (_st1, o1), ev_one = _launch_census(
        lambda: one(box["one"], buf, r, h, b))
    K.reset_launch_counts()
    (_st2, o2), ev_mesh = _launch_census(
        lambda: fused(box["mesh"], buf, r, h, b))
    step_launches = (K.schedule_batch_cuda.launches
                     + K.schedule_batch_repair_cuda.launches)
    release_launches = K.release_batch_cuda.launches
    g = SS.gather_state(box["mesh"])
    step_err = _max_err([(o1, o2), (box["one"].free_mb, g.free_mb),
                         (box["one"].conc_free, g.conc_free),
                         (box["one"].health, g.health)])
    reset()
    _, syncs_one = _count_syncs(lambda: one(box["one"], buf, r, h, b))
    _, syncs_mesh = _count_syncs(lambda: fused(box["mesh"], buf, r, h, b))
    # the mesh's release fold alone (the packed release-only fold over the
    # same rows): its launches, host syncs and device events
    fold = FM.make_fleet_release_packed(mesh, release)
    reset()
    K.reset_launch_counts()
    _, syncs_fold = _count_syncs(lambda: fold(box["mesh"], rel))
    fold_launches = K.release_batch_cuda.launches
    reset()
    _, ev_fold = _launch_census(lambda: fold(box["mesh"], rel))
    one_ms = time_ms(lambda: one(box["one"], buf, r, h, b), reset, torch,
                     reps=9)
    mesh_ms = time_ms(lambda: fused(box["mesh"], buf, r, h, b), reset,
                      torch, reps=9)
    require(step_err == 0 and step_launches == 0,
            f"7m(a): the mesh's fused step equals the single device's "
            f"(max_abs_err {step_err}) with no placement kernel launched "
            f"({step_launches})")
    require(DEVICE != "cuda" or (release_launches == fold_launches == MESH_S
                                 and syncs_fold == 0),
            f"7m(a): the mesh's release fold is one release launch a shard "
            f"(fused step {release_launches}, fold {fold_launches}, "
            f"{MESH_S} shards) with no host sync ({syncs_fold})")
    shard = SS.shard_state(state, mesh).shards[0]
    return dict(cases_s=cases_s, fused_s=time.perf_counter() - t0,
                cases=n_cases, max_abs_err=err, rounds_equal=rounds_equal,
                rounds=rounds, placement_kernel_launches=mesh_launches,
                fused_step=dict(
                    B=b, R=r, H=h, rounds=int(o2[-1]), max_abs_err=step_err,
                    device_events={"mesh": ev_mesh, "single": ev_one},
                    host_syncs={"mesh": syncs_mesh, "single": syncs_one},
                    ms={"mesh": mesh_ms, "single": one_ms},
                    placement_kernel_launches={"mesh": step_launches},
                    release_launches={"mesh": release_launches},
                    release_fold=dict(launches=fold_launches,
                                      host_syncs=syncs_fold,
                                      device_events=ev_fold)),
                shard_bytes=sum(t.numel() * t.element_size() for t in shard),
                shard_rows=shard.free_mb.shape[0])


def _flag_stragglers():
    """An `on_wave` hook: MESH_Q_FLAGGED invokers flagged as stragglers in
    the anomaly plane's scores at every wave (a tick of its own would
    replace them), the quality plane's inputs refreshed."""
    from openwhisk_tpu_torch.ops.anomaly import N_SCORE_ROWS, \
        S_STRAGGLER_FLAG
    flags = np.zeros(N_PAD, np.float32)
    flags[np.random.RandomState(5).choice(N_INV, MESH_Q_FLAGGED,
                                          replace=False)] = 1

    async def flag(bal, _w):
        sc = np.zeros((N_SCORE_ROWS, bal._n_pad), np.float32)
        sc[S_STRAGGLER_FLAG] = flags[:bal._n_pad]
        bal.anomaly._scores = sc
        bal._refresh_quality_signals()
    return flag


def _keep_shadow(bal, SS, box):
    """Wrap the balancer's shadow pass: the first pass whose penalty holds
    a flag is kept in `box["kept"]` (the global books before it, the
    buffer, the penalty, the shape and its vector); passes are counted."""
    shadow = bal._shadow_fn
    box["passes"] = 0

    def kept_shadow(state, buf, penalty, *shape, scratch=None):
        keep = "kept" not in box and bool(bal._shadow_penalty_np.any())
        books = SS.gather_state(state) if keep else None
        out = shadow(state, buf, penalty, *shape, scratch=scratch)
        box["passes"] += 1
        if keep:
            box["kept"] = dict(books=books, buf=buf.clone(),
                               penalty=penalty.clone(), shape=shape,
                               out=out.clone())
        return out
    bal._shadow_fn = kept_shadow


def _mesh_front(torch, P, K, TB, TT, JN, SS, work):
    """7m(b): phase 7's front through the mesh balancer (a journal
    attached before the fleet registers) and through the single-device
    card balancer, the quality plane on in both (7m(c)). The mesh run's
    recorded steps replay through the single-device card functions from
    the same books; its journal replays on the CPU at S = MESH_S (the
    same books) and at one shard (a cold start); its snapshot restores
    onto a single-device card balancer."""
    import os
    from openwhisk_tpu_torch.core import entity as E
    from openwhisk_tpu_torch.messaging import MemoryMessagingProvider
    jdir = os.path.join(work, "wal")
    box = {}

    def setup(bal):
        box["bal"] = bal
        bal.attach_journal(JN.PlacementJournal(jdir))
        _keep_shadow(bal, SS, box)

    t0 = time.perf_counter()
    with _environ({QUALITY_ON: "true", QUALITY_EVERY: str(MESH_Q_EVERY)}):
        mout, rec, (books0, _bk0, books), _ = asyncio.run(_front_run(
            TB, K, None, "0", MESH_WAVES, MESH_TRICKLE, profile=False,
            flap=True, setup=setup, on_wave=_flag_stragglers(),
            balancer_kw=dict(fleet_mesh=True, fleet_shards=MESH_S)))
    bal = box["bal"]
    bal.journal.close()
    mesh_s = time.perf_counter() - t0
    require(not mout["failed"] and not mout["unresolved"]
            and not mout["errors"] and mout["active_at_end"] == 0
            and mout["books_full"],
            f"7m(b): the mesh front resolved every activation, books full: "
            f"{mout['failed_first']} {mout['errors']}")
    require(bal.kernel_resolved == "sharded" and bal.n_shards == MESH_S
            and mout["launches"] == {"scan": 0, "repair": 0},
            f"7m(b): the mesh balancer launched no placement kernel: "
            f"{mout['launches']}")
    require(mout["flap"]["down"] == mout["flap"]["invokers"]
            == mout["flap"]["back"], f"7m(b): the flap: {mout['flap']}")
    t1 = time.perf_counter()
    bad, steps, st = rec.replay(books0, None, P, TB, TT, device=DEVICE,
                                pair=TB._cuda_pair("auto"))
    card_equal = all(np.array_equal(x, y)
                     for x, y in zip(_books_np(st), books))
    replay_s = time.perf_counter() - t1
    require(bad == 0 and steps == mout["steps"] and card_equal,
            f"7m(b): the single-device card functions replay the mesh's "
            f"steps to the same decisions and books: {bad} of {steps} "
            f"differ, books equal {card_equal}")

    occ = bal.occupancy()
    fleet = occ["fleet"]
    rows = occ["shards"]
    require(len(rows) == MESH_S
            and sum(x["capacity_mb"] for x in rows) == fleet["capacity_mb"]
            and sum(x["used_mb"] for x in rows) == fleet["used_mb"]
            and sum(x["invokers"] for x in rows) == N_INV,
            f"7m(b): the per-shard occupancy rows sum to the fleet: {rows}")
    snap = bal.snapshot()

    async def restore_single():
        single = _cold_balancer(TB, "5")
        single._await_kernels()
        single.restore(snap)
        eq = _same_books(single, books)
        await single.close()
        return eq

    async def cpu_replay(**kw):
        cpu = TB.TpuBalancer(
            MemoryMessagingProvider(), E.ControllerInstanceId("6"),
            managed_fraction=0.9, blackbox_fraction=0.1, max_batch=MAX_BATCH,
            action_slots=A, initial_pad=64, device="cpu", **kw)
        stats = cpu.replay_journal(JN.PlacementJournal(jdir).records(0))
        eq = _same_books(cpu, books)
        await cpu.close()
        return stats, eq

    t2 = time.perf_counter()
    snap_equal = asyncio.run(restore_single())
    st8, eq8 = asyncio.run(cpu_replay(fleet_mesh=True, fleet_shards=MESH_S))
    st1, _eq1 = asyncio.run(cpu_replay())
    cpu_s = time.perf_counter() - t2
    require(snap_equal, "7m(b): the mesh snapshot restores onto a "
                        "single-device card balancer with equal books")
    require(eq8 and st8["parity_mismatches"] == 0 and "skipped" not in st8
            and st8["batches"] == mout["steps"],
            f"7m(b): the mesh journal replays on the CPU at S = {MESH_S} to "
            f"the card's books: {st8}")
    require(st1.get("skipped") == "mesh_topology"
            and st1["journal_shards"] == MESH_S,
            f"7m(b): at one shard the journal cold-starts: {st1}")

    t3 = time.perf_counter()
    with _environ({QUALITY_ON: "true", QUALITY_EVERY: str(MESH_Q_EVERY)}):
        sout, _srec, _sb, _ = asyncio.run(_front_run(
            TB, K, None, "1", MESH_WAVES, MESH_TRICKLE, profile=False,
            flap=True, on_wave=_flag_stragglers()))
    single_s = time.perf_counter() - t3
    require(not sout["failed"] and sout["books_full"]
            and sout["launches"]["repair"] > 0,
            f"7m(b): the single-device front ran on the kernels: "
            f"{sout['launches']}")
    keep = ("activations", "activations_per_s", "step_ms_p50_p99",
            "placement_ms_p50_p99", "steps", "mean_repair_rounds",
            "launches", "register_s")
    box["out"] = mout
    return box, dict(mesh={k: mout[k] for k in keep},
                single={k: sout[k] for k in keep},
                occupancy_shards=rows, card_replay=dict(
                    steps=steps, mismatched_steps=bad,
                    books_equal=card_equal, s=replay_s),
                snapshot_restore_single_equal=snap_equal,
                cpu_replay=dict(backend="cpu", s8=dict(
                    batches=st8["batches"],
                    parity_mismatches=st8["parity_mismatches"],
                    books_equal=eq8), s1=dict(skipped=st1.get("skipped"),
                                              journal_shards=st1.get(
                                                  "journal_shards")),
                                s=cpu_s),
                run_s=dict(mesh=mesh_s, single=single_s))


def _mesh_quality(torch, P, TB, SS, box):
    """7m(c): the quality plane of 7m(b)'s mesh run. Every step scored and
    every MESH_Q_EVERY-th shadowed, no failure swallowed; the kept flagged
    pass run again through the single-device plain shadow step with the
    plain penalized repair on the card, on the same books: the two
    vectors must be equal. The scorer's gather of the books is timed
    beside its bytes."""
    out = box["out"]
    q = out["quality"]
    require(not out["quality_failures"]
            and q["batches"] == out["steps"]
            and q["shadow_batches"] == out["steps"] // MESH_Q_EVERY
            and "kept" in box,
            f"7m(c): the mesh's quality plane scored every step and "
            f"shadowed every {MESH_Q_EVERY}th, a flagged pass kept: "
            f"{q['batches']} {q['shadow_batches']} {out['steps']} "
            f"{out['quality_failures'][:3]}")
    kept = box["kept"]
    R, H, B = kept["shape"]
    plain = P.make_shadow_step_packed(TB._torch_pair("auto")[1],
                                      P.schedule_batch_repair)
    want = plain(kept["books"], kept["buf"], kept["penalty"], R, H, B)
    exact = torch.equal(want, kept["out"])
    require(exact, "7m(c): the kept mesh shadow pass equals the "
                   "single-device plain penalized repair on the same books")
    sharded = box["bal"].state
    gather_ms = time_ms(lambda: SS.gather_state(sharded), lambda: None,
                        torch, reps=9)
    gbytes = sum(t.numel() * t.element_size() for s in sharded.shards
                 for t in s)
    return dict(steps=out["steps"], shadow_passes=box["passes"],
                shadow_batches=q["shadow_batches"],
                divergent_rows=q["divergent_rows"], R=R, H=H, B=B,
                penalty_flags=int(kept["penalty"].sum()), plain_exact=exact,
                scorer_gather=dict(ms=gather_ms, bytes=gbytes,
                                   bound_ms=2 * gbytes / HBM_BYTES_S * 1e3))


def _mesh_wide(torch, TB, SS):
    """7m(d): the mesh balancer and the single-device card balancer, each
    restored from one snapshot of MESH_WIDE_INV invokers at N = 262,144
    and A = MESH_WIDE_A, take the same MESH_WIDE_STEPS publish_many waves
    of MAX_BATCH rows: the same decision for every row, the same books,
    and no placement kernel launched by the mesh."""
    from openwhisk_tpu_torch.core import entity as E
    from openwhisk_tpu_torch.messaging import MemoryMessagingProvider
    from openwhisk_tpu_torch.ops import placement_cuda as K
    n_pad = 1 << (MESH_WIDE_INV - 1).bit_length()
    snap = {"n_pad": n_pad, "cluster_size": 1, "action_slots": MESH_WIDE_A,
            "journal_seq": 0,
            "registry": [E.InvokerInstanceId(
                i, user_memory=E.MB(MEM_MB)).to_json()
                for i in range(MESH_WIDE_INV)],
            "healthy": [True] * MESH_WIDE_INV,
            "free_mb": [MEM_MB] * MESH_WIDE_INV, "conc_nonzero": []}

    coprimes = {}  # the partitions' probe steps, computed once for both

    async def run(ctrl, **kw):
        bal = TB.TpuBalancer(
            MemoryMessagingProvider(), E.ControllerInstanceId(ctrl),
            managed_fraction=0.9, blackbox_fraction=0.1,
            max_batch=MAX_BATCH, action_slots=MESH_WIDE_A, initial_pad=64,
            device=None if DEVICE == "cuda" else DEVICE, **kw)
        bal._await_kernels()
        bal.restore(snap)
        bal._coprimes = coprimes
        decisions, real = [], bal._map_placement

        def record(inv_idx, forced, *rest):
            decisions.append((int(inv_idx), bool(forced)))
            return real(inv_idx, forced, *rest)
        bal._map_placement = record
        mix = ActionMix(seed=17, ctrl=E.ControllerInstanceId(ctrl))
        K.reset_launch_counts()
        for _ in range(MESH_WIDE_STEPS):
            await asyncio.gather(*bal.publish_many(mix.pairs(MAX_BATCH)))
        torch.cuda.synchronize()
        launches = (K.schedule_batch_cuda.launches
                    + K.schedule_batch_repair_cuda.launches)
        books = SS.gather_state(bal.state) if bal.mesh is not None \
            else bal.state
        out = (decisions, books, launches, list(bal.step_ms),
               bal.counters["repair_rounds"])
        bal._map_placement = real
        await bal.close()
        return out

    t0 = time.perf_counter()
    d1, b1, l1, ms1, r1 = asyncio.run(run("3"))
    t1 = time.perf_counter()
    d2, b2, l2, ms2, r2 = asyncio.run(run("4", fleet_mesh=True,
                                          fleet_shards=MESH_S))
    t2 = time.perf_counter()
    equal = (d1 == d2 and all(torch.equal(x, y) for x, y in zip(b1, b2))
             and r1 == r2)
    require(equal and len(d2) == MESH_WIDE_STEPS * MAX_BATCH
            and l2 == 0 and l1 > 0,
            f"7m(d): at N = {n_pad} the mesh places as the single-device "
            f"card balancer ({len(d1)} / {len(d2)} rows, equal {equal}) "
            f"with no placement kernel ({l2}; single device {l1})")
    return dict(N=n_pad, A=MESH_WIDE_A, invokers=MESH_WIDE_INV,
                steps=MESH_WIDE_STEPS, rows=len(d2), equal=equal,
                repair_rounds=r2,
                forced=sum(f for _, f in d2),
                step_ms={"mesh": ms2, "single": ms1},
                placement_kernel_launches={"mesh": l2, "single": l1},
                run_s={"single": t1 - t0, "mesh": t2 - t1})


def mesh_phase(torch, P, K, TB, card):
    """Phase 7m: the fleet mesh of MESH_S shards on the card."""
    import shutil
    import tempfile
    from openwhisk_tpu_torch.controller.loadbalancer import journal as JN
    from openwhisk_tpu_torch.ops import throttle as TT
    from openwhisk_tpu_torch.parallel import fleet_mesh as FM
    from openwhisk_tpu_torch.parallel import sharded_state as SS
    mesh = FM.make_fleet_mesh(MESH_S, device=None if DEVICE == "cuda"
                              else DEVICE)
    res = {}
    t0 = time.perf_counter()
    res["ops"] = _mesh_ops(torch, P, K, TB, FM, SS, mesh)
    say("mesh", segment="ops", nvidia_smi=card,
        devices=[str(d) for d in mesh.devices],
        seconds=time.perf_counter() - t0, **res["ops"])
    work = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    try:
        t0 = time.perf_counter()
        box, res["front"] = _mesh_front(torch, P, K, TB, TT, JN, SS, work)
        say("mesh", segment="front", nvidia_smi=card,
            seconds=time.perf_counter() - t0, **res["front"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    res["quality"] = _mesh_quality(torch, P, TB, SS, box)
    say("mesh", segment="quality", nvidia_smi=card,
        seconds=time.perf_counter() - t0, **res["quality"])
    t0 = time.perf_counter()
    res["wide"] = _mesh_wide(torch, TB, SS)
    say("mesh", segment="wide", nvidia_smi=card,
        seconds=time.perf_counter() - t0, **res["wide"])
    res["launches"] = {k: res["front"]["mesh"]["launches"][k]
                       for k in ("scan", "repair")}
    return res


# --------------------------------------------------------------- phase 7b
#: the journal phase: phase 7's traffic at JOURNAL_WAVES waves with a
#: journal attached before the fleet registers, the snapshot dumped at the
#: start of wave JOURNAL_SNAP_WAVE, the debugger's activation taken from
#: wave JOURNAL_AID_WAVE, and the rate-limited balancer's waves
JOURNAL_WAVES, JOURNAL_SNAP_WAVE, JOURNAL_AID_WAVE = 24, 12, 20
JOURNAL_RATE_WAVES = 8


def _cold_balancer(TB, ctrl_id):
    """A traffic-free balancer of phase 7's configuration on the card to
    restore and replay onto (built inside a running loop, closed by the
    caller)."""
    from openwhisk_tpu_torch.core import entity as E
    from openwhisk_tpu_torch.messaging import MemoryMessagingProvider
    return TB.TpuBalancer(
        MemoryMessagingProvider(), E.ControllerInstanceId(ctrl_id),
        managed_fraction=0.9, blackbox_fraction=0.1, max_batch=MAX_BATCH,
        action_slots=A, initial_pad=64,
        device=None if DEVICE == "cuda" else DEVICE)


def _count_syncs(fn):
    """fn() with torch's sync debug mode on "warn": (result, the host-device
    synchronisations it made). On the CPU there is nothing to count."""
    import warnings
    if not torch.cuda.is_available():
        return fn(), None
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing" in str(w.message) for w in got)


def _measured_replay(TB, K, bal, fn):
    """Run the replay `fn()` on `bal` with its kernel launches bracketed by
    CUDA events and its synchronisations counted: (fn's result, the
    replay's numbers)."""
    bal._await_kernels()  # no warm step inside the timers or sync count
    timed = [time_launches(TB, k) for k in ("schedule_batch_cuda",
                                            "schedule_batch_repair_cuda")]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out, syncs = _count_syncs(fn)
        torch.cuda.synchronize()
    finally:
        for _, undo in timed:
            undo()
    wall = time.perf_counter() - t0
    (scan_ms, _), (rep_ms, _) = (launch_ms(p) for p, _ in timed)
    return out, dict(
        s=wall, host_syncs=syncs,
        launches={"scan": K.schedule_batch_cuda.launches,
                  "repair": K.schedule_batch_repair_cuda.launches},
        kernel_ms_p50={"scan": scan_ms, "repair": rep_ms},
        kernel_ms_total={k: float(sum(s.elapsed_time(e) for s, e in p))
                         for k, (p, _) in zip(("scan", "repair"), timed)})


def _same_books(bal, books):
    """The balancer's books equal phase 7's host copy (free, conc [A, N],
    health) bit for bit; rows and slots past the live books' shape (a
    larger pad or slot axis) must be empty."""
    mine = _books_np(bal.state)
    a, n = books[1].shape
    return (np.array_equal(mine[0][:n], books[0])
            and np.array_equal(mine[1][:a, :n], books[1])
            and np.array_equal(mine[2][:n], books[2])
            and not mine[0][n:].any() and not mine[1][a:].any()
            and not mine[1][:, n:].any())


def journal_phase(torch, P, K, TB, front):
    """Phase 7b: the journal, snapshot and replay at phase 7's geometry."""
    import shutil
    import tempfile
    from openwhisk_tpu_torch.controller.loadbalancer import checkpoint as CK
    from openwhisk_tpu_torch.controller.loadbalancer import journal as JN
    from openwhisk_tpu_torch.controller.loadbalancer import timetravel as TT
    work = tempfile.mkdtemp(prefix="chip-smoke-journal-")
    try:
        return _journal_phase(P, K, TB, front, CK, JN, TT, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _journal_phase(P, K, TB, front, CK, JN, TT, work):
    import os
    jdir, snap = os.path.join(work, "wal"), os.path.join(work, "bal.snap")
    journal = JN.PlacementJournal(jdir)
    append_us, lag, box = {}, [0], {}
    real_write = CK.write_snapshot

    def setup(bal):
        bal.attach_journal(journal)
        append = bal._journal_append

        def timed(rec):
            t = time.perf_counter()
            seq = append(rec)
            append_us.setdefault(rec["t"], []).append(
                (time.perf_counter() - t) * 1e6)
            return seq
        bal._journal_append = timed

    async def on_wave(bal, w):
        lag[0] = max(lag[0], journal.lag_batches)
        if w == JOURNAL_AID_WAVE:
            box["aid_after_seq"] = bal._journal_seq
        if w != JOURNAL_SNAP_WAVE:
            return
        # the periodic snapshotter's own tick: capture on the loop, write
        # on a worker thread, prune what the dump covers
        snapper = CK.BalancerSnapshotter(bal, snap, 3600.0, journal=journal)
        parts_fn = bal.snapshot_parts
        # the capture's pieces, timed apart once before it: the registry's
        # serialization and the three clones' enqueue
        t = time.perf_counter()
        [inv.to_json() for inv in bal._registry]
        t1 = time.perf_counter()
        st = bal.state
        (st.free_mb.clone(), st.conc_free.T.clone(), st.health.clone())
        box["parts_split_ms"] = dict(registry=(t1 - t) * 1e3,
                                     clones=(time.perf_counter() - t1) * 1e3)

        def parts():
            gc_ms, starts = [], []

            def on_gc(phase, info):
                if phase == "start":
                    starts.append(time.perf_counter())
                elif starts:
                    gc_ms.append((time.perf_counter() - starts.pop()) * 1e3)
            gc.callbacks.append(on_gc)
            t = time.perf_counter()
            try:
                out = parts_fn()
            finally:
                gc.callbacks.remove(on_gc)
            box["parts_ms"] = (time.perf_counter() - t) * 1e3
            box["parts_split_ms"]["gc_during_capture"] = sum(gc_ms)
            return out

        def write(*a, **k):
            t = time.perf_counter()
            real_write(*a, **k)
            box["write_ms"] = (time.perf_counter() - t) * 1e3

        bal.snapshot_parts, CK.write_snapshot = parts, write
        try:
            await snapper._dump()
        finally:
            bal.snapshot_parts, CK.write_snapshot = parts_fn, real_write
        box["snap_bytes"] = os.path.getsize(snap)

    t0 = time.perf_counter()
    out, _rec, (_b0, _bk0, books), _prof = asyncio.run(_front_run(
        TB, K, None, "0", JOURNAL_WAVES, FRONT_TRICKLE, profile=False,
        flap=True, setup=setup, on_wave=on_wave))
    live_s = time.perf_counter() - t0
    journal.close()
    require(not out["failed"] and not out["unresolved"] and not out["errors"]
            and out["active_at_end"] == 0 and out["books_full"],
            f"journal: every activation resolved, books full: "
            f"{out['failed_first']} {out['errors']}")
    records = list(JN.PlacementJournal(jdir).records(0))
    require(records and records[0]["seq"] == 1,
            "journal: the log holds the full history")
    kinds = {}
    for r in records:
        n = len(json.dumps(r, separators=(",", ":"))) + 10  # + frame header
        row = kinds.setdefault(r["t"], {"records": 0, "bytes": 0})
        row["records"] += 1
        row["bytes"] += n
    require({"reg", "grow", "batch", "ack", "fold"} <= set(kinds),
            f"journal: the log holds every kind of record: {sorted(kinds)}")
    full = [r for r in records if r["t"] == "batch" and r["b"] == MAX_BATCH]
    doc = json.load(open(snap))
    require(doc["version"] == 2 and len(doc["registry"]) == N_INV,
            "journal: the snapshot holds the fleet")

    # (a) snapshot + tail, (b) full history with no snapshot: on the card
    async def card_replay(snapshot_path):
        bal = _cold_balancer(TB, "2")
        got = {}
        restore, replay = bal.restore, bal.replay_journal

        def timed_restore(s):
            t = time.perf_counter()
            restore(s)
            got["restore_ms"] = (time.perf_counter() - t) * 1e3

        def measured(*a, **k):
            got["stats"], got["replay"] = _measured_replay(
                TB, K, bal, lambda: replay(*a, **k))
            return got["stats"]

        bal.restore, bal.replay_journal = timed_restore, measured
        got["loaded"] = CK.load_snapshot(
            bal, snapshot_path, journal=JN.PlacementJournal(jdir))
        got["equal"] = _same_books(bal, books)
        await bal.close()
        return got

    res = {"snapshot_tail": asyncio.run(card_replay(snap)),
           "full_history": asyncio.run(card_replay(
               os.path.join(work, "missing.snap")))}
    for label, got in res.items():
        st, rp = got["stats"], got["replay"]
        say("journal_replay", replay=label, loaded=got["loaded"],
            books_equal=got["equal"], restore_ms=got.get("restore_ms"),
            stats={k: v for k, v in st.items()}, **rp)
        require(got["equal"] and st["parity_mismatches"] == 0
                and st["batches"] >= 1,
                f"journal {label}: the card replay is bit-exact: {st}")
        require(rp["launches"]["scan"] > 0 and rp["launches"]["repair"] > 0,
                f"journal {label}: both kernels ran in the replay: "
                f"{rp['launches']}")
    require(res["snapshot_tail"]["loaded"] is True
            and res["full_history"]["loaded"] is False,
            "journal: (a) restored the snapshot, (b) had none")

    # (c) the same full history through the plain versions on the CPU
    async def cpu_replay():
        bal = TT.make_offline_balancer(device="cpu")
        t = time.perf_counter()
        st = bal.replay_journal(JN.PlacementJournal(jdir).records(0))
        dt = time.perf_counter() - t
        eq = _same_books(bal, books)
        await bal.close()
        return st, dt, eq

    cst, cpu_s, cpu_equal = asyncio.run(cpu_replay())
    require(cpu_equal and cst["parity_mismatches"] == 0,
            f"journal: the card's journal replays on the CPU to the same "
            f"books: {cst}")

    # (d) a rate-limited balancer's journal: acks carry throttled bits
    rdir = os.path.join(work, "wal-rate")
    rjournal = JN.PlacementJournal(rdir)
    rout, _r, (_rb0, _rbk, rbooks), _p = asyncio.run(_front_run(
        TB, K, RATE_LIMIT, "1", JOURNAL_RATE_WAVES, 0, profile=False,
        flap=False, setup=lambda bal: bal.attach_journal(rjournal)))
    rjournal.close()
    rrecs = list(JN.PlacementJournal(rdir).records(0))
    throttled_acks = sum(any((v >> 1) & 1 for v in r["out"])
                         for r in rrecs if r["t"] == "ack")
    require(rout["throttled"] > 0 and throttled_acks > 0,
            "journal: the rate-limited run journaled throttled rows")

    async def rate_replay():
        bal = _cold_balancer(TB, "3")
        st, rp = _measured_replay(TB, K, bal, lambda: bal.replay_journal(
            JN.PlacementJournal(rdir).records(0)))
        eq = _same_books(bal, rbooks)
        await bal.close()
        return st, rp, eq

    rst, rrp, requal = asyncio.run(rate_replay())
    require(requal and rst["parity_mismatches"] == 0,
            f"journal: the rate-limited journal replays bit-exact: {rst}")

    # (e) the time-travel debugger on the card
    aid_batch = next(r for r in records if r["t"] == "batch"
                     and r["seq"] > box["aid_after_seq"])
    aid = aid_batch["aids"][0]
    # acks apply through their batch records and are not steps: stop at
    # the last record that changed the books at or before the snapshot
    at_snap = max(r["seq"] for r in records
                  if r["seq"] <= doc["journal_seq"] and r["t"] != "ack")

    async def debug():
        dbg = TT.JournalDebugger(records,
                                 device=None if DEVICE == "cuda" else DEVICE)
        try:
            stop = dbg.run_to_seq(at_snap)
            diff = dbg.diff_books(doc)
            hit = dbg.run_to_activation(aid)
            dec = dbg.decisions()
            keep = [not t for t in dec["throttled"]]
            agree = ([d for d, k in zip(dec["derived"], keep) if k]
                     == [r for r, k in zip(dec["recorded"], keep) if k])
            return stop, diff, hit, agree
        finally:
            await dbg.aclose()

    stop, diff, hit, agree = asyncio.run(debug())
    require(stop["seq"] == at_snap and diff["match"]
            and diff["captured_seq"] == doc["journal_seq"],
            f"journal: the debugger's books match the snapshot at its seq: "
            f"{ {k: diff[k] for k in diff if k != 'free_mb_mismatches'} }")
    require(hit is not None and hit["seq"] == aid_batch["seq"] and agree,
            "journal: the debugger stopped at the wave's batch, its "
            "decisions derived as recorded")

    n_rec = len(records)
    n_batch = kinds["batch"]["records"]
    card_replays = [res["snapshot_tail"]["replay"],
                    res["full_history"]["replay"], rrp]
    line = dict(
        records=n_rec, by_type=kinds,
        full_batch_record=dict(
            rows=MAX_BATCH, bytes=(len(json.dumps(full[0],
                                                  separators=(",", ":")))
                                   + 10 if full else None)),
        append_us_per_record={k: dict(mean=float(np.mean(v)),
                                      p50=float(np.median(v)), n=len(v))
                              for k, v in append_us.items()},
        fsync_p99_ms=journal.fsync_p99_ms(), lag_batches_max=lag[0],
        snapshot=dict(journal_seq=doc["journal_seq"],
                      parts_ms_on_loop=box["parts_ms"],
                      parts_split_ms=box["parts_split_ms"],
                      write_ms_on_worker=box["write_ms"],
                      file_bytes=box["snap_bytes"],
                      conc_cells=len(doc["conc_nonzero"])),
        restore_ms=res["snapshot_tail"]["restore_ms"],
        replay_card={label: dict(
            records=got["stats"]["replayed"],
            batches=got["stats"]["batches"], s=got["replay"]["s"],
            records_per_s=got["stats"]["replayed"] / got["replay"]["s"],
            batches_per_s=got["stats"]["batches"] / got["replay"]["s"],
            host_syncs=got["replay"]["host_syncs"],
            launches=got["replay"]["launches"],
            kernel_ms_p50=got["replay"]["kernel_ms_p50"],
            kernel_ms_total=got["replay"]["kernel_ms_total"])
            for label, got in res.items()},
        replay_cpu=dict(backend="cpu", records=cst["replayed"],
                        batches=cst["batches"], s=cpu_s,
                        records_per_s=cst["replayed"] / cpu_s,
                        batches_per_s=cst["batches"] / cpu_s),
        replay_rate_limited=dict(records=rst["replayed"],
                                 batches=rst["batches"],
                                 throttled_acks=throttled_acks,
                                 launches=rrp["launches"],
                                 host_syncs=rrp["host_syncs"]),
        debugger=dict(snapshot_seq=doc["journal_seq"], match=diff["match"],
                      activation=aid, batch_seq=hit["seq"]),
        front_pair=dict(
            journal_on=dict(waves=JOURNAL_WAVES,
                            activations_per_s=out["activations_per_s"],
                            step_ms_p50=out["step_ms_p50_p99"][0],
                            register_s=out["register_s"]),
            journal_off_phase7=dict(
                waves=FRONT_WAVES,
                activations_per_s=front["main"]["activations_per_s"],
                step_ms_p50=front["main"]["step_ms_p50_p99"][0],
                register_s=front["main"]["register_s"])),
        live_s=live_s, batches=n_batch)
    say("journal", **line)
    line["replay_launches"] = {
        k: sum(r["launches"][k] for r in card_replays)
        for k in ("scan", "repair")}
    line["replay_ms"] = {
        k: sum(r["kernel_ms_total"][k] for r in card_replays)
        / max(1, line["replay_launches"][k]) for k in ("scan", "repair")}
    return line


# ------------------------------------------------------- the device planes
#: the planes phase at the full fleet: 10,000 invokers padded to N, the
#: JAX package's default 24 latency buckets and 256 namespace rows
PLANE_BUCKETS, PLANE_NS = 24, 256
PLANE_E = (8, 64, 4096)
PLANE_TICKS, PLANE_TICK_E = 30, 4096


def _plane_subjects():
    """The three slow invokers and the bursting one, spread over the
    fleet."""
    return (3, N_INV * 47 // 100, N_INV * 9 // 10), 77 % N_INV


#: the stated tolerances: float sums and scores against the NumPy twin
PLANE_RTOL, PLANE_ATOL = 1e-5, 1e-5
#: the smoke's ranges around the plane programs (torch.profiler windows)
PLANE_RANGES = ("telemetry_fold", "anomaly_step")
#: the A/B's off switches (the JAX package's knobs)
PLANES_OFF = {"CONFIG_whisk_telemetry_enabled": "false",
              "CONFIG_whisk_anomaly_enabled": "false",
              "CONFIG_whisk_profiling_enabled": "false"}
PLANES_AB_WAVES = 12


def _plane_events(rng, e, tick=None):
    """A seeded int32[5, e] event matrix over the fleet: duplicate invoker
    and namespace indices, a quarter of the rows padding, a tenth of the
    latencies on the bounds or past int32; with `tick`, three slow
    invokers and an error burst on one (ticks 10-12)."""
    from openwhisk_tpu_torch.ops import telemetry as T
    ev = np.zeros((5, e), np.int32)
    k = max(1, 3 * e // 4)
    slow, burst = _plane_subjects()
    ev[0, :k] = rng.randint(0, N_INV, k)
    if tick is not None:  # the slow and bursting invokers take traffic
        ev[0, :k:7] = rng.choice(slow + (burst,), len(ev[0, :k:7]))
    else:
        ev[0, :k:3] = rng.randint(0, 8, len(ev[0, :k:3]))  # duplicates
    ev[1, :k] = rng.randint(0, PLANE_NS, k)
    lat = rng.lognormal(3.0, 0.3, k) * 1000
    if tick is None:
        edge = rng.rand(k) < 0.1
        lat[edge] = rng.choice([1000, 1001, 2 ** 21 * 1000, 10 ** 9,
                                T.LAT_US_MAX], int(edge.sum()))
    else:
        lat[np.isin(ev[0, :k], slow)] *= 8
    ev[2, :k] = np.minimum(lat, T.LAT_US_MAX).astype(np.int64)
    ev[3, :k] = 0 if tick is not None else rng.randint(0, 3, k)
    if tick is not None and 10 <= tick < 13:
        ev[3, :k][ev[0, :k] == burst] = T.OUTCOME_ERROR
    ev[4, :k] = 1
    ev[0, k:] = rng.randint(0, N_INV, e - k)  # padding rows add nothing
    ev[2, k:] = rng.randint(0, 10 ** 6, e - k)
    return ev


def _state_bytes(state):
    return sum(t.numel() * t.element_size() for t in state)


def _fold_need_bytes(ev, n_buckets):
    """The bytes a scatter-add of `ev` needs: the event matrix read once,
    and each accumulator cell its valid rows touch (distinct (invoker,
    bucket), (namespace, bucket), invoker, namespace, (invoker, outcome)
    and (namespace, outcome) cells, 4 bytes each) read and written once.
    This run's data decides the count: duplicates touch a cell once and
    padding rows touch none."""
    from openwhisk_tpu_torch.ops import telemetry as T
    v = ev[:, ev[4] == 1].astype(np.int64)
    inv = np.clip(v[0], 0, N_PAD - 1)
    ns = np.clip(v[1], 0, PLANE_NS - 1)
    b = T.bucket_of_us(v[2], n_buckets)
    k = np.clip(v[3], 0, T.N_OUTCOMES - 1)
    cells = sum(len(np.unique(x)) for x in (
        inv * n_buckets + b, ns * n_buckets + b, inv, ns,
        inv * T.N_OUTCOMES + k, ns * T.N_OUTCOMES + k))
    return ev.nbytes + 2 * 4 * cells


def _counts_agree(dev, twin):
    """(max abs int error, max rel float error) of device counts against
    the twin's; ints must be exact, floats within PLANE_RTOL."""
    int_err, rel = 0, 0.0
    for f, v in twin.items():
        d = np.asarray(dev[f])
        if v.dtype.kind == "f":
            rel = max(rel, float(np.max(np.abs(d - v) / np.maximum(
                np.abs(v), 1e-30), initial=0.0)))
        else:
            int_err = max(int_err, int(np.max(np.abs(d.astype(np.int64) - v),
                                              initial=0)))
    return int_err, rel


def _sync_debug(torch, fn):
    """fn() with any synchronizing CUDA call raising."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _device_ms(prof, names):
    """Kernel time launched under each host range of `names` (the
    profiler's recursive device time of the range's CPU event): calls and
    ms per call."""
    cpu_t = torch.autograd.DeviceType.CPU
    out = {}
    for name in names:
        evs = [e for e in prof.events()
               if e.name == name and e.device_type == cpu_t]
        tot = sum(e.device_time_total if hasattr(e, "device_time_total")
                  else e.cuda_time_total for e in evs) / 1e3
        out[name] = dict(calls=len(evs), device_ms=tot,
                         device_ms_per_call=(tot / len(evs) if evs
                                             else None))
    return out


def planes_phase(torch):
    """The device planes at the full fleet on the card: the telemetry fold
    against the NumPy twin, 30 anomaly ticks against the twin and against
    the plain torch step on the CPU, the fold and the tick under
    sync-debug "error", and both programs timed with CUDA events beside
    their byte bounds."""
    from openwhisk_tpu_torch.controller.loadbalancer import anomaly as AP
    from openwhisk_tpu_torch.controller.loadbalancer import telemetry as TP
    from openwhisk_tpu_torch.ops import anomaly as AN
    from openwhisk_tpu_torch.ops import telemetry as T
    rng = np.random.RandomState(23)
    out = {"N": N_PAD, "buckets": PLANE_BUCKETS, "namespaces": PLANE_NS}
    # (a) record_packed on the card against the twin, at each fold size
    fold = {}
    for e in PLANE_E:
        dev = T.DeviceLatencyAccumulator(N_PAD, PLANE_NS, PLANE_BUCKETS,
                                         device=DEVICE)
        twin = T.NumpyLatencyAccumulator(N_PAD, PLANE_NS, PLANE_BUCKETS)
        for _ in range(3):
            ev = _plane_events(rng, e)
            dev.fold(ev)
            twin.fold(ev)
        int_err, rel = _counts_agree(dev.counts(), twin.counts())
        fold[e] = dict(int_err=int_err, float_rel_err=rel)
        require(int_err == 0 and rel <= PLANE_RTOL,
                f"telemetry fold E={e} on the card equals the twin: "
                f"{fold[e]}")
    out["fold_vs_twin"] = fold
    # (b) 30 anomaly ticks on the card against the twin and the plain
    # torch step on the CPU
    c = AP.AnomalyConfig()
    cfg = (c.alpha, c.z_threshold, c.spike_threshold, c.min_samples,
           c.mad_floor_ms)
    acc = T.DeviceLatencyAccumulator(N_PAD, PLANE_NS, PLANE_BUCKETS,
                                     device=DEVICE)
    step = AN.make_anomaly_step(*cfg)
    st_dev = AN.init_anomaly(N_PAD, PLANE_BUCKETS, device=DEVICE)
    st_cpu = AN.init_anomaly(N_PAD, PLANE_BUCKETS, device="cpu")
    st_np = AN.init_anomaly_np(N_PAD, PLANE_BUCKETS)
    score_err, cpu_mismatch, flag_diff, borderline = 0.0, 0, 0, 0
    flagged = set()
    for tick in range(PLANE_TICKS):
        acc.fold(_plane_events(rng, PLANE_TICK_E, tick))
        s = acc.state
        st_dev, sc_dev = step(st_dev, s.inv_buckets, s.inv_lat_ms,
                              s.inv_outcomes)
        cnt = acc.counts()
        st_cpu, sc_cpu = step(st_cpu, *(torch.from_numpy(cnt[f]) for f in (
            "inv_buckets", "inv_lat_ms", "inv_outcomes")))
        st_np, sc_np = AN.anomaly_step_np(
            st_np, cnt["inv_buckets"], cnt["inv_lat_ms"],
            cnt["inv_outcomes"], *cfg)
        sc = sc_dev.cpu().numpy()
        cpu_mismatch += int(not np.array_equal(sc, sc_cpu.numpy()))
        score_err = max(score_err, float(np.max(
            np.abs(sc - sc_np) - PLANE_RTOL * np.abs(sc_np))))
        # a flag may differ from the float64 twin's only where the twin's
        # score lies within the stated tolerance of its threshold
        near = {row: np.abs(sc_np[row] - thr) <= PLANE_ATOL
                + PLANE_RTOL * thr for row, thr in (
                    (AN.S_STRAGGLER, c.z_threshold),
                    (AN.S_ERR_SPIKE, c.spike_threshold),
                    (AN.S_TM_SPIKE, c.spike_threshold))}
        for row, excused in (
                (AN.S_STRAGGLER_FLAG, near[AN.S_STRAGGLER]),
                (AN.S_ANOMALY_FLAG, near[AN.S_STRAGGLER]
                 | near[AN.S_ERR_SPIKE] | near[AN.S_TM_SPIKE])):
            diff = sc[row] != sc_np[row]
            borderline += int((diff & excused).sum())
            flag_diff += int((diff & ~excused).sum())
        flagged |= {(tick, int(i))
                    for i in np.nonzero(sc[AN.S_ANOMALY_FLAG])[0]}
    out["anomaly_vs_twin"] = dict(
        ticks=PLANE_TICKS, score_err_past_tolerance=score_err,
        flag_mismatches=flag_diff, borderline_flags=borderline,
        ticks_differing_from_cpu_torch=cpu_mismatch,
        flagged_invokers=sorted({i for _, i in flagged})[:16],
        burst_flagged=(10, _plane_subjects()[1]) in flagged)
    require(score_err <= PLANE_ATOL and flag_diff == 0,
            f"anomaly scores and flags on the card equal the twin's: "
            f"{out['anomaly_vs_twin']}")
    require(cpu_mismatch == 0,
            "the card's anomaly step is bit-exact with the CPU torch step")
    slow, burst = _plane_subjects()
    require(set(slow) <= {i for _, i in flagged} and (10, burst) in flagged,
            "the slow invokers and the error burst flagged")
    # (c) the fold and the tick under sync-debug "error", through the
    # planes as the balancer runs them
    tp = TP.TelemetryPlane(TP.TelemetryConfig(buckets=PLANE_BUCKETS,
                                              namespaces=PLANE_NS))
    tp.use_device(N_PAD, DEVICE)
    plane = AP.AnomalyPlane(AP.AnomalyConfig(), AP.AlertsConfig())
    names = [f"invoker{i}" for i in range(N_INV)]
    plane.attach(telemetry=tp, invoker_names=lambda: names)

    def observe_tick(tick):
        ev = _plane_events(rng, PLANE_TICK_E, tick)
        for col in ev[:, ev[4] == 1].T:
            tp.observe(int(col[0]), f"ns{col[1]}", col[2] / 1e3, int(col[3]))

    observe_tick(0)
    tp.device_fold()
    plane.tick(now=1.0)  # warm: the carry and the step are built
    torch.cuda.synchronize()
    for tick in range(1, 6):
        observe_tick(tick)
        _sync_debug(torch, tp.device_fold)
        _sync_debug(torch, lambda: plane.tick(now=1.0 + tick))
        torch.cuda.synchronize()
    out["sync_debug"] = dict(folds=tp.accumulator.folds,
                             device_ticks=plane.device_ticks,
                             harvested=plane.harvested,
                             step_failures=plane.step_failures)
    require(plane.step_failures == 0 and plane.harvested >= 1
            and tp.pending == 0,
            f"fold and tick ran under sync-debug error: {out['sync_debug']}")
    # (d) times from CUDA events beside the byte bounds
    times = {}
    for e in (64, 4096):
        dev = T.DeviceLatencyAccumulator(N_PAD, PLANE_NS, PLANE_BUCKETS,
                                         device=DEVICE)
        ev = _plane_events(rng, e)
        ms = time_ms(lambda: dev.fold(ev), lambda: None, torch, reps=50)
        nbytes = _fold_need_bytes(ev, PLANE_BUCKETS)
        b_ms, b_by = bound(nbytes, 0)
        # what this design moves besides: each fold writes a NEW state
        # (out of place, so a scrape's snapshot stays whole), reading and
        # writing all six tensors whatever E is
        copy_bytes = 2 * _state_bytes(dev.state) + ev.nbytes
        times[f"fold_E{e}"] = dict(
            ms=ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
            out_of_place_bytes=copy_bytes,
            out_of_place_ms=bound(copy_bytes, 0)[0])
    s = acc.state
    st = st_dev
    ms = time_ms(lambda: step(st, s.inv_buckets, s.inv_lat_ms,
                              s.inv_outcomes), lambda: None, torch, reps=50)
    n = N_PAD
    nbytes = (2 * (_state_bytes((s.inv_buckets, s.inv_lat_ms,
                                 s.inv_outcomes)))
              + 5 * n * 4            # carry EWMAs and ticks read
              + 5 * n * 4            # and written
              + AN.N_SCORE_ROWS * n * 4)
    b_ms, b_by = bound(nbytes, 0)
    times["anomaly_step"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                                 bytes=nbytes)
    # the kernels' own time over the same calls (device busy, no host)
    prof = torch.profiler.profile(activities=PROFILE_ACTIVITIES)
    dev = T.DeviceLatencyAccumulator(N_PAD, PLANE_NS, PLANE_BUCKETS,
                                     device=DEVICE)
    ev = _plane_events(rng, 4096)
    torch.cuda.synchronize()
    prof.start()
    for _ in range(10):
        with torch.profiler.record_function("telemetry_fold"):
            dev.fold(ev)
        with torch.profiler.record_function("anomaly_step"):
            step(st, s.inv_buckets, s.inv_lat_ms, s.inv_outcomes)
    torch.cuda.synchronize()
    prof.stop()
    out["device_busy"] = _device_ms(prof, PLANE_RANGES)
    out["times"] = times
    return out


def _annotate_planes(bal):
    """Route the balancer's telemetry fold and anomaly step through
    torch.profiler ranges (the smoke's instrumentation), so a profile
    window attributes their kernels."""
    tp, an = bal.telemetry, bal.anomaly
    fold, tick = tp.device_fold, an._tick_device

    def fold_ranged(*a, **k):
        with torch.profiler.record_function("telemetry_fold"):
            return fold(*a, **k)

    def tick_ranged(*a, **k):
        with torch.profiler.record_function("anomaly_step"):
            return tick(*a, **k)
    tp.device_fold, an._tick_device = fold_ranged, tick_ranged


def _plane_report(bal):
    """The device planes' counters after a run (the balancer's own)."""
    tp, an = bal.telemetry, bal.anomaly
    if not tp.enabled:
        return dict(enabled=False, anomaly=an.enabled,
                    profiler=bal.profiler.enabled)
    slo = tp.slo_report(bal._telemetry_invoker_names())
    kp = bal.kernel_profile()
    return dict(
        enabled=True,
        events_observed=tp._events_total, folds=tp.accumulator.folds,
        pending=tp.pending, dropped=tp.dropped_events,
        fold_failures=bal.counters["telemetry_fold_failures"],
        anomaly_ticks=an.device_ticks, harvested=an.harvested,
        step_failures=an.step_failures,
        slo_count=slo["global"]["count"],
        slo_compliant=slo["global"]["compliant"],
        compiles={k: kp["compiles"][k] for k in ("expected", "unexpected")},
        kernel_builds=[(b["source"], b["how"], b["seconds"])
                       for b in kp["kernel_builds"]],
        hbm_bytes_in_use=bal.metrics.gauge_value(
            "loadbalancer_hbm_bytes_in_use"),
        firing=sum(an.engine.firing_counts().values()))


def _require_planes(rep, completed, what):
    require(rep["pending"] == 0 and rep["dropped"] == 0
            and rep["fold_failures"] == 0 and rep["step_failures"] == 0,
            f"{what}: every event folded, no plane failure: {rep}")
    require(rep["events_observed"] == rep["slo_count"] == completed,
            f"{what}: the telemetry counted every completed activation "
            f"({completed}): {rep}")
    require(rep["anomaly_ticks"] >= 1 and rep["harvested"] >= 1,
            f"{what}: anomaly ticks ran and harvested: {rep}")
    require(rep["compiles"]["unexpected"] == 0
            and {s for s, *_ in rep["kernel_builds"]} >= {
                "placement_scan", "placement_repair"},
            f"{what}: no signature churn, the kernel builds censused")
    require((rep["hbm_bytes_in_use"] or 0) > 0,
            f"{what}: loadbalancer_hbm_bytes_in_use above 0")


# ------------------------------------------------------------- phase 5b
#: fleets padded past 2^17 (the scan kernel's wide instance): 140,000
#: invokers pad to N = 2^18 at the balancer's A = 4,096 (conc is 4 GiB),
#: managed 0.9 (a 126,000-invoker partition, within 2^17); N = 2^20 holds
#: 1,000,000 invokers at A = 256 with partitions of up to 2^17 anywhere
WIDE_INV, WIDE_PAD = 140_000, 1 << 18
WIDE_BIG_INV, WIDE_BIG_PAD, WIDE_BIG_A = 1_000_000, 1 << 20, 256
WIDE_B, WIDE_TRICKLE = 16, 20


def wide_case(n_inv, n_pad, a, seed, torch, P, managed=None):
    """Books on the card (n_inv invokers in n_pad rows, some full, 2% down,
    permits on the batch's slot rows) and a WIDE_B-row batch: with
    `managed`, the balancer's partitions (managed [0, managed), blackbox
    the rest); else windows of up to 2^17 anywhere in the fleet."""
    rng = np.random.RandomState(seed)
    b = WIDE_B
    if managed is not None:
        bb = rng.rand(b) < 0.1
        off = np.where(bb, managed, 0)
        size = np.where(bb, n_inv - managed, managed)
    else:
        size = rng.randint(1, min(1 << 17, n_inv) + 1, b)
        off = np.array([rng.randint(0, n_inv - s + 1) for s in size])
    home = rng.randint(0, 1 << 30, b) % size
    rand = rng.randint(0, 1 << 30, b) % size
    step_inv = np.array([_inv(rng, s) for s in size])
    need = rng.choice([128, 256, 512, 1024, 2048], b)
    slot = rng.randint(0, 8, b)
    maxc = np.where(rng.rand(b) < 0.3, 4, 1)
    valid = rng.rand(b) < 0.95
    free = np.zeros(n_pad, np.int32)
    free[:n_inv] = rng.choice([0, 512, 2048, MEM_MB], n_inv,
                              p=[0.3, 0.1, 0.1, 0.5])
    health = np.zeros(n_pad, bool)
    health[:n_inv] = rng.rand(n_inv) >= 0.02
    conc = torch.zeros((a, n_pad), dtype=torch.int32, device=DEVICE)
    vals = np.where(rng.rand(8, n_inv) < 0.02,
                    rng.randint(1, 4, (8, n_inv)), 0).astype(np.int32)
    conc[:8, :n_inv] = torch.from_numpy(vals).to(DEVICE)
    state = P.PlacementState(torch.from_numpy(free).to(DEVICE), conc.T,
                             torch.from_numpy(health).to(DEVICE))
    batch = P.request_batch_from_numpy(off, size, home, step_inv, need, slot,
                                       maxc, rand, valid, device=DEVICE)
    pen = torch.from_numpy(rng.randint(0, 4, n_pad).astype(np.int32)).to(
        DEVICE)
    return state, batch, pen


def wide_kernel(label, state, batch, pen, torch, P, K):
    """The scan at a wide fleet against the plain version (with and
    without a penalty, bit-exact), timed with CUDA events beside the
    plain version, with its bound and launch shape."""
    for p in (None, pen):
        err, _, _ = compare("scan", state, batch, p, P, K, torch)
        require(err == 0, f"wide scan {label} (penalty {p is not None}) "
                          f"differs from plain by {err}")
    work = clone_state(P, state)
    kview = K.to_transposed(work)

    def restore():
        work.free_mb.copy_(state.free_mb)
        work.conc_free.copy_(state.conc_free)

    ms = time_ms(lambda: K.schedule_batch_cuda(kview, batch), restore,
                 torch)
    plain_ms = time_ms(lambda: P.schedule_batch(work, batch), restore,
                       torch, reps=3)
    nbytes, ops, _ = work_bytes_ops("scan", state, batch, None, P)
    bound_ms, bound_by = bound(nbytes, ops)
    row = dict(N=int(state.free_mb.shape[0]),
               A=int(state.conc_free.shape[1]), B=int(batch.valid.shape[0]),
               valid_rows=int(batch.valid.sum()), ms=ms, plain_ms=plain_ms,
               bytes=nbytes, key_evals=ops, bound_ms=bound_ms,
               bound_by=bound_by, max_abs_err=0,
               cluster=K.schedule_batch_cuda.cluster)
    say("wide_kernel", case=label, **row)
    del work, kview
    return row


async def _wide_balancer_run(TB, K):
    """`TpuBalancer` over WIDE_INV invokers registered by pings (the books
    grow to N = 2^18 on the card): WIDE_TRICKLE single invokes, each acked
    at once, every one placed by the scan. The simulated fleet pings once,
    so the supervision's offline timeout is raised for the run."""
    from openwhisk_tpu_torch.core import entity as E
    errors = []

    class Log:
        def error(self, _tid, msg, *_):
            errors.append(msg)

        def warn(self, *_):
            pass

        def info(self, *_):
            pass

    ctrl = E.ControllerInstanceId("2")
    fleet = Fleet(seed=23, echo=True, n_inv=WIDE_INV)
    fleet.start()
    bal = TB.TpuBalancer(
        fleet.provider, ctrl, logger=Log(), managed_fraction=0.9,
        blackbox_fraction=0.1, max_batch=MAX_BATCH, action_slots=A,
        initial_pad=64, device=None if DEVICE == "cuda" else DEVICE)
    bal.supervision.ping_timeout = 3600.0
    await bal.start()
    out = {}
    try:
        t0 = time.perf_counter()
        await fleet.ping(bal.supervision, list(range(WIDE_INV)))
        out["register_s"] = time.perf_counter() - t0
        require(len(bal._registry) == WIDE_INV and all(bal._healthy)
                and bal.state.free_mb.shape[0] == WIDE_PAD,
                f"wide fleet registered, pad {bal.state.free_mb.shape[0]}")
        bal._arm_flush()
        await _drain_front(bal)
        mix = ActionMix(seed=29, ctrl=ctrl)
        box, undo = capture_next(TB, "schedule_batch_cuda")
        K.reset_launch_counts()
        placed, refused = [], []
        for _ in range(WIDE_TRICKLE):
            a, msg = mix.pairs(1)[0]
            try:
                placed.append(await bal.publish(a, msg))
            except Exception as e:  # noqa: BLE001 — counted and reported
                refused.append(repr(e))
            await _drain_front(bal)
        out["launches"] = {"scan": K.schedule_batch_cuda.launches,
                           "repair": K.schedule_batch_repair_cuda.launches}
        undo()
        out["managed"], out["blackbox"] = bal.managed_count, \
            bal.blackbox_count
        results = await asyncio.gather(*placed, return_exceptions=True)
        out.update(placed=sum(hasattr(r, "response") for r in results),
                   refused=len(refused), refused_first=refused[:3],
                   errors=errors[:3],
                   active_at_end=bal.total_active_activations,
                   step_ms_p50_p99=list(_percentiles(bal.step_ms)))
    finally:
        await bal.close()
        await fleet.stop()
    return out, box


def wide_phase(torch, P, K, TB):
    """Phase 5b: the scan past 2^17 padded invokers, at the kernel and
    through the balancer."""
    rows = {}
    state, batch, pen = wide_case(WIDE_INV, WIDE_PAD, A, 31, torch, P,
                                  managed=int(0.9 * WIDE_INV))
    rows["N262144_B16"] = wide_kernel("N262144_B16", state, batch, pen,
                                      torch, P, K)
    del state, batch, pen
    state, batch, pen = wide_case(WIDE_BIG_INV, WIDE_BIG_PAD, WIDE_BIG_A,
                                  37, torch, P)
    rows["N1048576_B16"] = wide_kernel("N1048576_B16", state, batch, pen,
                                       torch, P, K)
    del state, batch, pen
    torch.cuda.empty_cache()
    run, box = asyncio.run(_wide_balancer_run(TB, K))
    say("wide_balancer", **run)
    require(run["placed"] == WIDE_TRICKLE and not run["refused"]
            and not run["errors"] and run["active_at_end"] == 0,
            f"the {WIDE_INV}-invoker balancer placed every trickle invoke: "
            f"{run}")
    require(run["launches"]["scan"] >= WIDE_TRICKLE,
            f"the scan placed the wide trickle: {run['launches']}")
    free0, conc0, health = box["state"]
    kept = K.to_transposed(P.PlacementState(free0, conc0, health))
    pen = torch.from_numpy(np.random.RandomState(41).randint(
        0, 4, free0.shape[0]).astype(np.int32)).to(free0.device)
    rows["kept_trickle"] = wide_kernel("kept_trickle", kept, box["batch"],
                                       pen, torch, P, K)
    del box, kept
    torch.cuda.empty_cache()
    return dict(rows, balancer=run)


# ---------------------------------------------------------------- phase 8
#: 8a, the standalone as a user runs it: sequential and concurrent blocking
#: invokes of `hello` on real python:3 process sandboxes
STANDALONE_SEQ, STANDALONE_CONC, STANDALONE_MEMORY_MB = 16, 48, 4096
#: 8b, the same assembly at the fleet: actions created over HTTP, blocking
#: invokes in flight from a client process, then a sequential trickle, and
#: the device profiled from HTTP_PROFILE_FROM scheduled rows for HTTP_PROFILE_S,
#: or until HTTP_PROFILE_TO rows, so that the window lies inside the
#: concurrent segment
HTTP_ACTIONS, HTTP_INVOKES, HTTP_INFLIGHT, HTTP_TRICKLE = 200, 8_000, 256, 200
HTTP_PROFILE_FROM, HTTP_PROFILE_TO, HTTP_PROFILE_S = 2_000, 7_000, 2.0
#: 8c, the coalescing A/B: blocking invokes a run (two runs)
AB_INVOKES = 1_000
#: the front door's throttles, raised so that nothing is throttled
UNTHROTTLED = dict(invocations_per_minute=10 ** 9,
                   concurrent_invocations=10 ** 9)

HELLO_CODE = ("def main(args):\n"
              "    return {'greeting': 'Hello ' + args.get('name', 'stranger')"
              " + '!'}\n")
FAIL_CODE = "def main(args):\n    return {'error': 'deliberate failure'}\n"
STEP_CODE = "def main(args):\n    return {'n': args.get('n', 0) + 1}\n"
ECHO_CODE = "def main(args):\n    return args\n"


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _standalone_kw():
    """No device argument on the card: the standalone's default is the card.
    The CPU rehearsal names its device."""
    return {} if DEVICE == "cuda" else {"device": DEVICE}


async def _standalone_run(K):
    """8a: the standalone with its in-process invoker, driven over HTTP."""
    import aiohttp
    from openwhisk_tpu_torch import standalone as S
    from openwhisk_tpu_torch.controller.loadbalancer.base import HEALTHY
    port = _free_port()
    ctrl = await S.make_standalone(
        port=port, balancer="tpu", ui=False,
        user_memory_mb=STANDALONE_MEMORY_MB, **UNTHROTTLED,
        **_standalone_kw())
    lb = ctrl.load_balancer
    base = f"http://127.0.0.1:{port}/api/v1/namespaces/_"
    out = {"device": str(lb.device)}
    try:
        async with aiohttp.ClientSession(
                auth=aiohttp.BasicAuth(S.GUEST_UUID, S.GUEST_KEY)) as s:
            async def put(name, exec_):
                async with s.put(f"{base}/actions/{name}",
                                 json={"exec": exec_}) as r:
                    require(r.status == 200, f"PUT {name}: {r.status}")

            async def invoke(name, args):
                async with s.post(f"{base}/actions/{name}?blocking=true"
                                  "&result=true", json=args) as r:
                    return r.status, await r.json()

            for name, code in (("hello", HELLO_CODE), ("failer", FAIL_CODE),
                               ("step", STEP_CODE)):
                await put(name, {"kind": "python:3", "code": code})
            await put("seq", {"kind": "sequence",
                              "components": ["_/step", "_/step"]})
            K.reset_launch_counts()
            t0 = time.perf_counter()
            seq = [await invoke("hello", {"name": f"n{i}"})
                   for i in range(STANDALONE_SEQ)]
            out["sequential_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            conc = await asyncio.gather(*[
                invoke("hello", {"name": f"c{i}"})
                for i in range(STANDALONE_CONC)])
            out["concurrent_s"] = time.perf_counter() - t0
            failer = await invoke("failer", {})
            chained = await invoke("seq", {"n": 1})
            out["launches"] = {"scan": K.schedule_batch_cuda.launches,
                               "repair": K.schedule_batch_repair_cuda.launches}
        out["sequential_ok"] = sum(
            st == 200 and body == {"greeting": f"Hello n{i}!"}
            for i, (st, body) in enumerate(seq))
        out["concurrent_ok"] = sum(
            st == 200 and body == {"greeting": f"Hello c{i}!"}
            for i, (st, body) in enumerate(conc))
        out["failing_status"] = failer[0]
        out["sequence"] = list(chained)
        out["invokers"] = [(h.id.as_string, h.status)
                           for h in lb.supervision.health()]
        out["healthy"] = any(h.status == HEALTHY
                             for h in lb.supervision.health())
    finally:
        await ctrl.stop()
    return out


def _zipf(n):
    p = np.arange(1, n + 1, dtype=float) ** -1.1
    return p / p.sum()


def http_client(cfg):
    """The load client of 8b, run in a process of its own (`--http-client
    CONFIG`): HTTP_INFLIGHT workers send the Zipf(1.1) mix of blocking
    invokes, each with its index as an argument, then one worker sends the
    trickle. Prints one JSON object: latencies, timestamps, failures and
    the process's CPU seconds."""
    import aiohttp
    cpu0 = time.process_time()

    async def run():
        rng = np.random.RandomState(cfg["seed"])
        names = cfg["names"]
        pick = rng.choice(len(names), cfg["invokes"] + cfg["trickle"],
                          p=_zipf(len(names)))
        conn = aiohttp.TCPConnector(limit=cfg["inflight"] + 8)
        lat = [0.0] * len(pick)
        bad = []
        async with aiohttp.ClientSession(
                connector=conn, auth=aiohttp.BasicAuth(*cfg["auth"])) as s:
            async def one(i):
                name = names[pick[i]]
                args = {"i": i, "action": name}
                t = time.perf_counter()
                async with s.post(f"{cfg['base']}/actions/{name}"
                                  "?blocking=true&result=true",
                                  json=args) as r:
                    body = await r.json()
                lat[i] = time.perf_counter() - t
                if r.status != 200 or body != args:
                    bad.append([i, r.status, body])

            todo = iter(range(cfg["invokes"]))

            async def worker():
                for i in todo:
                    await one(i)

            t_first = time.time()
            await asyncio.gather(*[worker() for _ in range(cfg["inflight"])])
            t_conc = time.time()
            for i in range(cfg["invokes"], len(pick)):
                await one(i)
            t_last = time.time()
        return dict(t_first=t_first, t_concurrent_end=t_conc, t_last=t_last,
                    latency_s=lat, bad=bad[:5], n_bad=len(bad))

    res = asyncio.run(run())
    res["cpu_s"] = time.process_time() - cpu0
    print(json.dumps(res))
    return 0


async def _profile_window(bal, box):
    """Profile the device from HTTP_PROFILE_FROM scheduled rows of the
    driven segment for HTTP_PROFILE_S, or until HTTP_PROFILE_TO rows. Gives
    up, leaving no profile, once box["stop"] is set."""
    def rows():
        return bal.counters["scheduled"] - box["scheduled0"]

    while rows() < HTTP_PROFILE_FROM:
        if box["stop"]:
            return
        await asyncio.sleep(0.005)
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=PROFILE_ACTIVITIES)
    prof.start()
    window = torch.profiler.record_function("http_window")
    window.__enter__()
    rows0, t_end = rows(), time.perf_counter() + HTTP_PROFILE_S
    while (time.perf_counter() < t_end and rows() < HTTP_PROFILE_TO
           and not box["stop"]):
        await asyncio.sleep(0.005)
    torch.cuda.synchronize()
    window.__exit__(None, None, None)
    box["rows"] = rows() - rows0
    t0 = time.perf_counter()
    prof.stop()
    box["prof"], box["stop_ms"] = prof, (time.perf_counter() - t0) * 1e3


def _warm_profiler():
    """The first profiler start of a process initializes the tracer for
    seconds: do it before the driven segment, not inside it."""
    prof = torch.profiler.profile(activities=PROFILE_ACTIVITIES)
    prof.start()
    torch.ones(8, device=DEVICE).sum().item()
    prof.stop()


async def _http_fleet_run(TB, K, invokes=None, trickle=None, full=True,
                          admin=None):
    """8b: the standalone's assembly over the simulated fleet, driven over
    HTTP by a client process: `invokes` blocking invokes in flight, then a
    `trickle` one at a time. `full` adds the step recorder (for the CPU
    replay) and the device profile window; without it the run is 8c's, an
    A/B leg. `await admin(bal, port)`, when given, reads the admin routes
    once the run drained (its result is the line's `admin`). The warnings
    of a quality-plane failure the balancer swallowed are the line's
    `quality_failures`."""
    invokes = HTTP_INVOKES if invokes is None else invokes
    trickle = HTTP_TRICKLE if trickle is None else trickle
    import aiohttp
    from openwhisk_tpu_torch import standalone as S
    from openwhisk_tpu_torch.core import entity as E
    E.ConcurrencyLimit.MAX = 16  # deployments opt in (the default caps at 1)
    fleet = Fleet(seed=13, echo=True)
    fleet.start()
    port = _free_port()
    ctrl = await S.make_standalone(
        port=port, balancer="tpu", ui=False, invoker=False,
        messaging_provider=fleet.provider, **UNTHROTTLED, **_standalone_kw())
    bal = ctrl.load_balancer
    _annotate_planes(bal)
    out = {"device": str(bal.device)}
    warnings, warn = [], bal.logger.warn

    def log_warn(transid, msg, component=""):
        warnings.append(str(msg))
        warn(transid, msg, component)
    bal.logger.warn = log_warn
    stop_pinging, pinger = asyncio.Event(), None
    try:
        t0 = time.perf_counter()
        await fleet.ping(bal.supervision, list(range(N_INV)))
        out["register_s"] = time.perf_counter() - t0
        require(len(bal._registry) == N_INV and all(bal._healthy)
                and bal.state.free_mb.shape[0] == N_PAD,
                f"fleet registered, pad {bal.state.free_mb.shape[0]}")
        bal._arm_flush()
        await _drain_front(bal)
        pinger = asyncio.get_event_loop().create_task(
            _keep_pinging(fleet, bal.supervision, stop_pinging))
        base = f"http://127.0.0.1:{port}/api/v1/namespaces/_"
        rng = np.random.RandomState(17)
        names = [f"a{k}" for k in range(HTTP_ACTIONS)]
        async with aiohttp.ClientSession(
                auth=aiohttp.BasicAuth(S.GUEST_UUID, S.GUEST_KEY)) as s:
            for name in names:
                limits = {"memory": int(rng.choice(range(128, 513, 64)))}
                if rng.rand() < 0.2:
                    limits["concurrency"] = int(rng.randint(2, 17))
                async with s.put(f"{base}/actions/{name}", json={
                        "exec": {"kind": "python:3", "code": ECHO_CODE},
                        "limits": limits}) as r:
                    require(r.status == 200, f"PUT {name}: {r.status}")
        books0 = _books_np(bal.state)
        rec = Recorder(bal, TB) if full else None
        host = fleet.host_s
        for k in host:
            host[k] = 0.0
        depth = [0]
        for name, key in (("publish_many", "balancer_publish_many"),
                          ("_dispatch_batch", "balancer_dispatch"),
                          ("_row_placed", "balancer_fan_out"),
                          ("process_acknowledgement", "balancer_ack"),
                          ("process_acknowledgement_frame", "balancer_ack")):
            _time_outer(bal, name, host, key, depth)
        _time_sends(bal, host, "balancer_send")
        cfg = dict(seed=19, names=names, invokes=invokes,
                   inflight=HTTP_INFLIGHT, trickle=trickle, base=base,
                   auth=[S.GUEST_UUID, S.GUEST_KEY])
        if full:
            _warm_profiler()
        box = {"scheduled0": bal.counters["scheduled"], "stop": not full,
               "prof": None}
        steps0 = len(bal.step_ms)
        counters0 = dict(bal.counters)
        planes = _planes(bal)
        fleet.wire = {k: [0, 0] for k in fleet.wire}
        obs_mark = _obs_mark()
        fr_filed0 = len(bal.flight_recorder) + bal.flight_recorder.dropped
        K.reset_launch_counts()
        cpu0 = time.process_time()
        prof_task = asyncio.get_event_loop().create_task(
            _profile_window(bal, box))
        client = await asyncio.create_subprocess_exec(
            sys.executable, __file__, "--http-client", json.dumps(cfg),
            stdout=asyncio.subprocess.PIPE)
        stdout, _ = await client.communicate()
        require(client.returncode == 0, f"http client exit {client.returncode}")
        res = json.loads(stdout.decode().strip().splitlines()[-1])
        await _drain_front(bal)
        if full:
            out["device_planes"] = await _admin_planes(bal, port)
        if admin is not None:
            out["admin"] = await admin(bal, port)
        stop_pinging.set()
        await pinger
        server_cpu = time.process_time() - cpu0
        launches = {"scan": K.schedule_batch_cuda.launches,
                    "repair": K.schedule_batch_repair_cuda.launches}
        host_obs = _obs_delta(obs_mark, invokes + trickle,
                              res["t_last"] - res["t_first"])
        fr_filed = (len(bal.flight_recorder) + bal.flight_recorder.dropped
                    - fr_filed0)
        box["stop"] = True
        await prof_task
        if rec is not None:
            rec.undo()
        torch.cuda.synchronize()
        books = _books_np(bal.state)
        lat = np.asarray(res["latency_s"]) * 1e3
        n = invokes
        d = {k: bal.counters[k] - counters0.get(k, 0) for k in
             ("steps", "scheduled", "repair_steps", "repair_rounds")}
        balancer_s = sum(v for k, v in host.items()
                         if k.startswith("balancer_"))
        fleet_s = sum(v for k, v in host.items() if k.startswith("fleet_"))
        out.update(
            invokes=n + trickle, inflight=HTTP_INFLIGHT,
            actions=HTTP_ACTIONS, n_bad=res["n_bad"], bad_first=res["bad"],
            invokes_per_s=(n + trickle) / (res["t_last"] - res["t_first"]),
            concurrent_invokes_per_s=n / (res["t_concurrent_end"]
                                          - res["t_first"]),
            http_ms_p50_p99_concurrent=list(_percentiles(lat[:n])),
            http_ms_p50_p99_trickle=list(_percentiles(lat[n:])),
            server_cpu_ms_per_invoke=server_cpu * 1e3 / (n + trickle),
            step_ms_p50_p99=list(_percentiles(list(bal.step_ms)[steps0:])),
            steps=d["steps"], rows_per_step=d["scheduled"] / max(1,
                                                                 d["steps"]),
            mean_repair_rounds=d["repair_rounds"] / max(1, d["repair_steps"]),
            launches=launches,
            active_at_end=bal.total_active_activations,
            books_full=bool((books[0][:N_INV] == MEM_MB).all()
                            and not books[1].any()
                            and books[2][:N_INV].all()),
            profile=(dict(_window_idle_share(box["prof"], "http_window"),
                          rows=box["rows"], stop_ms=box["stop_ms"],
                          device_planes=_device_ms(box["prof"],
                                                   PLANE_RANGES))
                     if box["prof"] is not None else None),
            host_s=dict(
                client=res["cpu_s"], balancer=balancer_s, fleet=fleet_s,
                api_entitlement_and_loop=server_cpu - balancer_s - fleet_s,
                server_process=server_cpu, split=host,
                wall=res["t_last"] - res["t_first"]),
            planes=planes, wire=fleet.wire_report(),
            host_observatory=host_obs, flight_recorder_records=fr_filed,
            quality_failures=[w for w in warnings
                              if w.startswith(QUALITY_FAILURES)])
    finally:
        stop_pinging.set()
        if pinger is not None:
            await pinger
        await ctrl.stop()
        await fleet.stop()
    return out, rec, books0, books


async def _admin_planes(bal, port):
    """8b's device planes over HTTP once the run drained: the
    supervision's tick twice (the last events fold; the anomaly step it
    enqueues harvests on the next), then `/admin/slo`, `/admin/alerts`,
    `/admin/anomalies` and `/admin/profile/kernel` with the guest key, and
    the balancer's own counters."""
    import aiohttp
    from openwhisk_tpu_torch import standalone as S
    ticks_in_run = bal.anomaly.device_ticks
    for _ in range(2):
        bal._telemetry_tick()
        torch.cuda.synchronize()
    url = f"http://127.0.0.1:{port}"
    got = {}
    async with aiohttp.ClientSession(
            auth=aiohttp.BasicAuth(S.GUEST_UUID, S.GUEST_KEY)) as s:
        for path in ("/admin/slo", "/admin/alerts", "/admin/anomalies",
                     "/admin/profile/kernel"):
            async with s.get(url + path) as r:
                got[path] = (r.status, await r.json())
    rep = dict(_plane_report(bal), ticks_in_run=ticks_in_run)
    slo, kp = got["/admin/slo"][1], got["/admin/profile/kernel"][1]
    rep["http"] = dict(
        status={p: st for p, (st, _) in got.items()},
        slo_count=slo["global"]["count"], slo_kernel=slo["kernel"],
        compiles_unexpected=kp["compiles"]["unexpected"],
        kernel_builds=len(kp["kernel_builds"]),
        hbm_bytes_in_use=kp["memory"].get("bytes_in_use"),
        alerts_active=len(got["/admin/alerts"][1]["active"]),
        anomalous=sum(r["anomalous"] for r in
                      got["/admin/anomalies"][1]["invokers"]))
    return rep


async def _keep_pinging(fleet, pool, stop):
    """Re-ping the whole fleet every REPING_S until `stop` is set: the
    supervision takes an invoker offline after 10 s without a ping."""
    while not stop.is_set():
        await fleet.keep_alive(pool)
        try:
            await asyncio.wait_for(stop.wait(), 0.25)
        except asyncio.TimeoutError:
            pass


def _time_outer(obj, name, acc, key, depth):
    """Route the synchronous obj.name through a wrapper that adds its wall
    time to acc[key] unless another such wrapper is already timing (an
    inline dispatch inside publish_many counts once)."""
    real = getattr(obj, name)
    acc.setdefault(key, 0.0)

    def timed(*a, **k):
        if depth[0]:
            return real(*a, **k)
        depth[0] += 1
        t = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            acc[key] += time.perf_counter() - t
            depth[0] -= 1
    setattr(obj, name, timed)


def http_phase(torch, P, K, TB):
    """Phase 8: the port's server over HTTP, 8a then 8b, with 8b's CPU
    replay."""
    t0 = time.perf_counter()
    sa = asyncio.run(_standalone_run(K))
    sa["run_s"] = time.perf_counter() - t0
    say("standalone", **sa)
    require(sa["sequential_ok"] == STANDALONE_SEQ
            and sa["concurrent_ok"] == STANDALONE_CONC,
            f"standalone invokes all 200 with their results: {sa}")
    require(sa["failing_status"] == 502, "the failing action answers 502")
    require(sa["sequence"] == [200, {"n": 3}], "the sequence chained")
    require(sa["launches"]["scan"] > 0, "the scan ran on the standalone")
    require(sa["healthy"], "the supervision registered the invoker healthy")
    t0 = time.perf_counter()
    out, rec, books0, books = asyncio.run(_http_fleet_run(TB, K))
    t1 = time.perf_counter()
    bad, steps, st = rec.replay(books0, None, P, TB, None)
    books_equal = all(np.array_equal(x, y)
                      for x, y in zip(books, _books_np(st)))
    out["cpu_replay"] = dict(steps=steps, events=len(rec.log),
                             mismatched_steps=bad, books_equal=books_equal,
                             cpu_s=time.perf_counter() - t1)
    out["run_s"] = t1 - t0
    say("http", **out)
    require(out["n_bad"] == 0, f"every invoke 200 with its echo: "
            f"{out['bad_first']}")
    require(out["launches"]["scan"] > 0 and out["launches"]["repair"] > 0,
            f"both kernels launched on the HTTP path: {out['launches']}")
    require(out["active_at_end"] == 0 and out["books_full"],
            "http: nothing active, books at full capacity")
    require(bad == 0 and books_equal, "http: card and CPU replay agree")
    require(out["profile"] is not None,
            "http: the device was profiled inside the concurrent segment")
    require(all(out["planes"].values()),
            f"http: the host planes at their defaults: {out['planes']}")
    require(out["host_observatory"].get("installed")
            and out["host_observatory"]["lag_ticks"] > 0
            and out["flight_recorder_records"] > 0,
            "http: Controller.start installed the observatory, the flight "
            "recorder filed")
    dp = out["device_planes"]
    _require_planes(dp, out["invokes"], "http")
    require(set(dp["http"]["status"].values()) == {200}
            and dp["http"]["slo_count"] == out["invokes"]
            and dp["http"]["compiles_unexpected"] == 0
            and dp["http"]["kernel_builds"] > 0
            and (dp["http"]["hbm_bytes_in_use"] or 0) > 0,
            f"http: the device planes' routes answer, /admin/slo counts "
            f"every invoke: {dp['http']}")
    out["ab"] = coalesce_ab(TB, K)
    return sa, out


def coalesce_ab(TB, K):
    """8c: phase 8b's configuration at AB_INVOKES blocking invokes a run,
    the coalescing producer on, then off
    (CONFIG_whisk_bus_coalesce_enabled), each run a fresh server and fleet:
    host numbers move by a fifth between calls, so the two settings are
    compared inside one call."""
    import os
    key = "CONFIG_whisk_bus_coalesce_enabled"
    prior = os.environ.get(key)
    runs = []
    try:
        for on in (True, False):
            os.environ[key] = "true" if on else "false"
            out, _rec, _b0, _b1 = asyncio.run(_http_fleet_run(
                TB, K, invokes=AB_INVOKES, trickle=0, full=False))
            row = dict(coalescing=on, planes=out["planes"],
                       invokes_per_s=out["invokes_per_s"],
                       http_ms_p50_p99=out["http_ms_p50_p99_concurrent"],
                       server_cpu_ms_per_invoke=out[
                           "server_cpu_ms_per_invoke"],
                       wire=out["wire"], n_bad=out["n_bad"],
                       tasks_per_invoke=out["host_observatory"].get(
                           "tasks_per_invoke"),
                       launches=out["launches"])
            say("http_ab", **row)
            require(out["n_bad"] == 0 and out["active_at_end"] == 0
                    and out["books_full"],
                    f"http A/B (coalescing {on}): every invoke 200, books "
                    f"full")
            require(out["planes"]["coalescing"] == on,
                    f"the A/B leg runs coalescing={on}")
            runs.append(row)
    finally:
        if prior is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = prior
    return runs


#: 8d, the restart: phase 8b's assembly with the balancer's snapshot and
#: journal, RESTART_INVOKES blocking invokes over RESTART_ACTIONS actions,
#: stop (the final dump), a second boot from the same files, then
#: RESTART_AFTER more invokes; the periodic snapshot every RESTART_SNAP_S
RESTART_ACTIONS, RESTART_INVOKES, RESTART_AFTER = 50, 1_000, 200
RESTART_SNAP_S = 2.0


async def _restart_boot(TB, K, paths, invokes, create):
    """One boot of 8d: the standalone over a fresh simulated fleet with the
    snapshot, journal and sqlite store at `paths`; the fleet pings in,
    `create` makes the actions over HTTP, `invokes` blocking invokes from
    the client process, then stop (the final dump). Returns the boot's
    numbers."""
    import aiohttp
    from openwhisk_tpu_torch import standalone as S
    from openwhisk_tpu_torch.database import open_store
    from openwhisk_tpu_torch.core import entity as E
    E.ConcurrencyLimit.MAX = 16
    timing = {}
    cls = TB.TpuBalancer
    restore, replay = cls.restore, cls.replay_journal

    def timed_restore(self, snap):
        t = time.perf_counter()
        restore(self, snap)
        timing["restore_s"] = time.perf_counter() - t

    def timed_replay(self, *a, **k):
        t = time.perf_counter()
        st = replay(self, *a, **k)
        timing["replay_s"] = time.perf_counter() - t
        timing["replay"] = {k: st[k] for k in ("replayed", "batches",
                                               "parity_mismatches")}
        return st

    t_wall = time.perf_counter()
    fleet = Fleet(seed=23, echo=True)
    fleet.start()
    port = _free_port()
    cls.restore, cls.replay_journal = timed_restore, timed_replay
    t0 = time.perf_counter()
    try:
        ctrl = await S.make_standalone(
            port=port, balancer="tpu", ui=False, invoker=False,
            messaging_provider=fleet.provider,
            artifact_store=open_store(paths["db"]),
            snapshot_path=paths["snap"], snapshot_interval=RESTART_SNAP_S,
            journal_dir=paths["wal"], **UNTHROTTLED, **_standalone_kw())
    finally:
        cls.restore, cls.replay_journal = restore, replay
    out = dict(boot_s=time.perf_counter() - t0, **timing)
    bal = ctrl.load_balancer
    out["registry_at_boot"] = len(bal._registry)
    out["books_at_boot"] = _books_np(bal.state)
    stop_pinging, pinger = asyncio.Event(), None
    base = f"http://127.0.0.1:{port}/api/v1/namespaces/_"
    try:
        async with aiohttp.ClientSession(
                auth=aiohttp.BasicAuth(S.GUEST_UUID, S.GUEST_KEY)) as s:
            async with s.get(f"http://127.0.0.1:{port}/admin/ready") as r:
                out["ready"] = [r.status, await r.json()]
            t0 = time.perf_counter()
            await fleet.ping(bal.supervision, list(range(N_INV)))
            out["ping_s"] = time.perf_counter() - t0
            require(len(bal._registry) == N_INV and all(bal._healthy),
                    "restart: the fleet is registered and healthy")
            bal._arm_flush()
            await _drain_front(bal)
            pinger = asyncio.get_event_loop().create_task(
                _keep_pinging(fleet, bal.supervision, stop_pinging))
            names = [f"r{k}" for k in range(RESTART_ACTIONS)]
            if create:
                rng = np.random.RandomState(29)
                for name in names:
                    limits = {"memory": int(rng.choice(range(128, 513, 64)))}
                    if rng.rand() < 0.2:
                        limits["concurrency"] = int(rng.randint(2, 17))
                    async with s.put(f"{base}/actions/{name}", json={
                            "exec": {"kind": "python:3", "code": ECHO_CODE},
                            "limits": limits}) as r:
                        require(r.status == 200, f"PUT {name}: {r.status}")
        K.reset_launch_counts()
        cfg = dict(seed=31 + invokes, names=names, invokes=invokes,
                   inflight=HTTP_INFLIGHT, trickle=0, base=base,
                   auth=[S.GUEST_UUID, S.GUEST_KEY])
        client = await asyncio.create_subprocess_exec(
            sys.executable, __file__, "--http-client", json.dumps(cfg),
            stdout=asyncio.subprocess.PIPE)
        stdout, _ = await client.communicate()
        require(client.returncode == 0,
                f"restart client exit {client.returncode}")
        res = json.loads(stdout.decode().strip().splitlines()[-1])
        await _drain_front(bal)
        out.update(invokes=invokes, n_bad=res["n_bad"],
                   bad_first=res["bad"],
                   invokes_per_s=invokes / (res["t_last"] - res["t_first"]),
                   launches={"scan": K.schedule_batch_cuda.launches,
                             "repair": K.schedule_batch_repair_cuda.launches},
                   journal_seq=bal._journal_seq,
                   fsync_p99_ms=bal.journal.fsync_p99_ms())
        stop_pinging.set()
        await pinger
        pinger = None
        out["books_at_stop"] = _books_np(bal.state)
    finally:
        stop_pinging.set()
        if pinger is not None:
            await pinger
        t0 = time.perf_counter()
        await ctrl.stop()
        out["stop_s"] = time.perf_counter() - t0
        await fleet.stop()
        out["wall_s"] = time.perf_counter() - t_wall
    return out


def restart_phase(TB, K):
    """Phase 8d: the standalone restarts from its own snapshot."""
    import os
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="chip-smoke-restart-")
    paths = {"db": os.path.join(work, "whisks.db"),
             "snap": os.path.join(work, "balancer.snap"),
             "wal": os.path.join(work, "wal")}
    try:
        first = asyncio.run(_restart_boot(TB, K, paths, RESTART_INVOKES,
                                          create=True))
        doc = json.load(open(paths["snap"]))
        second = asyncio.run(_restart_boot(TB, K, paths, RESTART_AFTER,
                                           create=False))
        snap_bytes = os.path.getsize(paths["snap"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    free, conc, _health = second["books_at_boot"]
    cells = [[int(i), int(j), int(conc[j, i])]
             for i, j in zip(*np.nonzero(conc.T))]
    books_equal = (free.tolist() == doc["free_mb"]
                   and cells == doc["conc_nonzero"])
    status, ready = second["ready"]
    line = dict(
        boots=[{k: v for k, v in b.items()
                if not k.startswith("books")} for b in (first, second)],
        final_dump=dict(journal_seq=doc["journal_seq"],
                        registry=len(doc["registry"]),
                        conc_cells=len(doc["conc_nonzero"])),
        snapshot_bytes=snap_bytes, books_equal_final_dump=books_equal)
    say("restart", **line)
    require(first["n_bad"] == 0 and second["n_bad"] == 0,
            f"restart: every invoke 200 with its echo: "
            f"{first['bad_first']} {second['bad_first']}")
    require(len(doc["registry"]) == N_INV
            and doc["journal_seq"] == first["journal_seq"],
            "restart: the final dump holds the fleet at the last seq")
    require(second["registry_at_boot"] == N_INV and books_equal,
            "restart: the second boot restored 10,000 invokers and the "
            "final dump's books")
    require(status == 200 and ready["journal"]["attached"]
            and ready["journal"]["stall_firing"] is False,
            f"restart: /admin/ready reports the journal: {ready}")
    require(second["replay"]["parity_mismatches"] == 0,
            f"restart: the tail replayed cleanly: {second['replay']}")
    return line


# ---------------------------------------------------------------- phase 9
DEPLOY_INVOKERS, DEPLOY_MEMORY_MB, DEPLOY_ACTION_MB = 4, 4_096, 128
DEPLOY_BURST, DEPLOY_BLOCKING, DEPLOY_INFLIGHT, DEPLOY_SEQUENTIAL = \
    64, 200, 16, 50
#: the front door's limits for the run (the CLI's defaults, 60 a minute
#: and 30 concurrent, would throttle the burst)
DEPLOY_LIMITS = {"CONFIG_whisk_limits_invocationsPerMinute": "1000000",
                 "CONFIG_whisk_limits_concurrentInvocations": "1000000"}
DEPLOY_TIMEOUT_S = 60.0


def deploy_controller(counts_path, argv):
    """`--deploy-controller PATH ARGS...`: the controller CLI's `main()`
    with ARGS, exactly as `python -m openwhisk_tpu_torch.controller ARGS`
    runs it, plus the kernel wrappers' launch counts in PATH: written on
    SIGUSR1, reset to 0 (and written) on SIGUSR2, and written at exit. The
    launches happen in this process, so phase 9 reads them here."""
    import atexit
    import os
    from openwhisk_tpu_torch.controller import __main__ as C
    from openwhisk_tpu_torch.ops import placement_cuda as K

    def dump(*_):
        tmp = f"{counts_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"scan": K.schedule_batch_cuda.launches,
                       "repair": K.schedule_batch_repair_cuda.launches,
                       "cuda_initialized": torch.cuda.is_initialized()}, f)
        os.replace(tmp, counts_path)

    def reset(*_):
        K.reset_launch_counts()
        dump()

    signal.signal(signal.SIGUSR1, dump)
    signal.signal(signal.SIGUSR2, reset)
    atexit.register(dump)
    sys.argv = ["openwhisk_tpu_torch.controller", *argv]
    C.main()
    return 0


def _signal_counts(proc, path, sig, what):
    """Ask a `--deploy-controller` process for its kernel launch counts
    (SIGUSR1 reads, SIGUSR2 resets) and wait for the file it writes."""
    import os
    stamp = os.path.getmtime(path) if os.path.exists(path) else None
    proc.send_signal(sig)
    for _ in range(500):
        if os.path.exists(path) and os.path.getmtime(path) != stamp:
            time.sleep(0.02)
            with open(path) as f:
                return json.load(f)
        time.sleep(0.01)
    raise RuntimeError(f"{what} wrote no launch counts")


class Deployment:
    """The broker, DEPLOY_INVOKERS invokers and one controller as OS
    processes on localhost, each started through its CLI, its output in a
    log file under `work`."""

    def __init__(self, work, device_args=()):
        import os
        self.work = work
        self.bus, self.api, self.mon = _free_port(), _free_port(), \
            _free_port()
        self.db = os.path.join(work, "whisks.db")
        self.snap = os.path.join(work, "balancer.snap")
        self.wal = os.path.join(work, "wal")
        self.counts = os.path.join(work, "launches.json")
        self.device_args = list(device_args)
        self.procs = {}
        self.started = {}

    def _start(self, name, argv, env=None):
        import os
        log = open(os.path.join(self.work, f"{name}.log"), "w")
        full_env = dict(os.environ, PYTHONUNBUFFERED="1", **(env or {}))
        self.started[name] = time.perf_counter()
        self.procs[name] = (subprocess.Popen(
            [sys.executable, *argv], stdout=log, stderr=subprocess.STDOUT,
            env=full_env), log)

    def start(self):
        bus = f"127.0.0.1:{self.bus}"
        self._start("broker", ["-m", "openwhisk_tpu_torch.messaging",
                               "--port", str(self.bus)])
        for i in range(DEPLOY_INVOKERS):
            self._start(f"invoker{i}", [
                "-m", "openwhisk_tpu_torch.invoker", "--bus", bus,
                "--db", self.db, "--unique-name", f"deploy-{i}",
                "--memory", str(DEPLOY_MEMORY_MB)])
        self._start("controller", [
            __file__, "--deploy-controller", self.counts,
            "--bus", bus, "--db", self.db, "--port", str(self.api),
            "--balancer", "tpu", "--seed-guest",
            "--balancer-journal", self.wal, "--balancer-snapshot", self.snap,
            "--balancer-snapshot-interval", "3600", *self.device_args],
            env=DEPLOY_LIMITS)
        self._start("monitoring", [
            "-m", "openwhisk_tpu_torch.controller.monitoring", "--bus", bus,
            "--port", str(self.mon)])

    def log(self, name):
        import os
        with open(os.path.join(self.work, f"{name}.log")) as f:
            return f.read()

    def wait_up(self, timeout=DEPLOY_TIMEOUT_S):
        """Seconds from each process's start to its "up" line (polled in
        its log); raises when one has not come up within `timeout`."""
        marks = {"broker": "listening on", "controller": " up on :",
                 "monitoring": "user-events metrics on"}
        up = {}
        t0 = time.perf_counter()
        while len(up) < len(self.procs):
            for name, (proc, _log) in self.procs.items():
                if name not in up and marks.get(name, ") up") in \
                        self.log(name):
                    up[name] = time.perf_counter() - self.started[name]
                require(proc.poll() is None,
                        f"deploy: {name} exited {proc.returncode}: "
                        f"{self.log(name)[-2000:]}")
            require(time.perf_counter() - t0 < timeout,
                    f"deploy: {sorted(set(self.procs) - set(up))} not up")
            time.sleep(0.05)
        return up

    def send(self, name, sig):
        self.procs[name][0].send_signal(sig)

    def launches(self, sig):
        """The controller's kernel launch counts (SIGUSR1 reads, SIGUSR2
        resets)."""
        return _signal_counts(self.procs["controller"][0], self.counts, sig,
                              "deploy: the controller")

    def stop(self):
        """SIGTERM the controller (its final dump), then the invokers and
        the broker; every process must exit 0 within 30 s."""
        rcs = {}
        order = ["controller"] + [n for n in self.procs
                                  if n.startswith("invoker")] + [
            n for n in ("monitoring",) if n in self.procs] + ["broker"]
        for name in order:
            proc, log = self.procs[name]
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:
                rcs[name] = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                rcs[name] = proc.wait()
            log.close()
        return rcs


async def _deploy_traffic(dep):
    """Drive the deployment over HTTP (module docstring, phase 9)."""
    import aiohttp
    from openwhisk_tpu_torch import standalone as S
    api = f"http://127.0.0.1:{dep.api}"
    base = f"{api}/api/v1/namespaces/_"
    out = {}
    conn = aiohttp.TCPConnector(limit=DEPLOY_BURST)
    async with aiohttp.ClientSession(
            connector=conn,
            auth=aiohttp.BasicAuth(S.GUEST_UUID, S.GUEST_KEY)) as s:
        t0 = time.perf_counter()
        invokers = {}
        while time.perf_counter() - t0 < DEPLOY_TIMEOUT_S:
            try:
                async with s.get(f"{api}/invokers") as r:
                    invokers = await r.json()
                if sum(v == "up" for k, v in invokers.items()
                       if k.startswith("invoker")) == DEPLOY_INVOKERS:
                    break
            except aiohttp.ClientError:
                pass
            await asyncio.sleep(0.2)
        out["fleet_up_s"] = time.perf_counter() - t0
        require(sum(v == "up" for v in invokers.values()) == DEPLOY_INVOKERS,
                f"deploy: all {DEPLOY_INVOKERS} invokers up: {invokers}")
        async with s.put(f"{base}/actions/echo", json={
                "exec": {"kind": "python:3", "code": ECHO_CODE},
                "limits": {"memory": DEPLOY_ACTION_MB}}) as r:
            require(r.status == 200, f"deploy: PUT echo {r.status}")
        bad = []

        async def blocking(n):
            t = time.perf_counter()
            async with s.post(f"{base}/actions/echo?blocking=true&result=true",
                              json={"n": n}) as r:
                body = await r.json()
                if r.status != 200 or body != {"n": n}:
                    bad.append((n, r.status, body))
            return (time.perf_counter() - t) * 1e3

        # the first invoke: a cold sandbox and the balancer's first launch
        out["first_invoke_ms"] = await blocking(-1)
        # warm every pooled connection, so the burst leaves at once
        await asyncio.gather(*[s.get(f"{api}/invokers")
                               for _ in range(DEPLOY_BURST)])
        launches0 = dep.launches(signal.SIGUSR2)  # counts to 0 before the path
        bursts = []
        aids = {}

        async def fire(n):
            async with s.post(f"{base}/actions/echo", json={"n": n}) as r:
                body = await r.json()
                if r.status != 202 or "activationId" not in body:
                    bad.append((n, r.status, body))
                else:
                    aids[body["activationId"]] = n

        t_burst = time.perf_counter()
        for k in range(3):
            # one admission wave: a step of at least 32 rows (the repair)
            await asyncio.gather(*[fire(k * DEPLOY_BURST + n)
                                   for n in range(DEPLOY_BURST)])
            bursts.append(dep.launches(signal.SIGUSR1))
            if bursts[-1]["repair"] > 0:
                break
        t_poll = time.perf_counter()
        pending = dict(aids)
        while pending and time.perf_counter() - t_poll < DEPLOY_TIMEOUT_S:
            for aid in list(pending):
                async with s.get(f"{base}/activations/{aid}") as r:
                    if r.status == 200:
                        rec = await r.json()
                        result = rec.get("response", {}).get("result")
                        if result != {"n": pending.pop(aid)}:
                            bad.append((aid, result))
            if pending:
                await asyncio.sleep(0.1)
        if pending:
            _report_502(bad, {n: dep.log(n) for n in dep.procs}, pending)
        require(not pending, f"deploy: {len(pending)} burst activations "
                             "never recorded")
        out["burst"] = dict(invokes=len(aids), waves=len(bursts),
                            recorded_s=time.perf_counter() - t_burst,
                            launches=bursts[-1])
        # DEPLOY_BLOCKING blocking invokes at DEPLOY_INFLIGHT in flight
        sem = asyncio.Semaphore(DEPLOY_INFLIGHT)

        async def limited(n):
            async with sem:
                return await blocking(n)

        t0 = time.perf_counter()
        conc_ms = await asyncio.gather(*[limited(10_000 + n)
                                         for n in range(DEPLOY_BLOCKING)])
        conc_s = time.perf_counter() - t0
        # DEPLOY_SEQUENTIAL one at a time: single-row steps (the scan)
        seq_ms = [await blocking(20_000 + n)
                  for n in range(DEPLOY_SEQUENTIAL)]
        out["launches"] = dep.launches(signal.SIGUSR1)
        out["launches_before"] = launches0
        if bad:
            _report_502(bad, {n: dep.log(n) for n in dep.procs})
        require(not bad, f"deploy: every response 200 with its echo: "
                         f"{bad[:5]}")
        out.update(
            invokes=len(aids) + DEPLOY_BLOCKING + DEPLOY_SEQUENTIAL + 1,
            invokes_per_s=DEPLOY_BLOCKING / conc_s,
            http_ms_p50_p99_concurrent=_percentiles(conc_ms),
            http_ms_p50_p99_sequential=_percentiles(seq_ms))
        await asyncio.sleep(1.0)  # the idle fold takes the last releases
        async with s.get(f"{api}/admin/ready") as r:
            out["ready"] = [r.status, await r.json()]
        async with s.get(f"{api}/admin/profile/kernel") as r:
            out["profile"] = [r.status, await r.json()]
        async with s.get(f"{api}/admin/latency/waterfall") as r:
            out["waterfall"] = [r.status, await r.json()]
    return out


#: activation events the smoke publishes to the monitoring service
USER_EVENTS = 64


async def _user_events(dep):
    """Phase 9's monitoring service: USER_EVENTS activation `EventMessage`s
    published onto the TCP bus's `events` topic from here (no controller or
    invoker of either package publishes them), then its /metrics read until
    it counts them (at most 30 s). Returns (the count it shows, seconds)."""
    import aiohttp
    from openwhisk_tpu_torch.core import entity as E
    from openwhisk_tpu_torch.messaging import EventMessage, provider_for_bus
    provider = provider_for_bus(f"127.0.0.1:{dep.bus}")
    prod = provider.get_producer()
    t0 = time.perf_counter()
    for i in range(USER_EVENTS):
        act = E.WhiskActivation(
            E.EntityPath("guest"), E.EntityName("monitored"),
            E.Subject("guest-user"), E.ActivationId.generate(), 1.0, 2.0,
            E.ActivationResponse.success({}), duration=i)
        await prod.send("events", EventMessage.for_activation(
            "invoker0", act, "uuid-1", kind="python:3"))
    await prod.close()
    series = 'openwhisk_userevents_activations_total{action="guest/monitored"}'
    count = None
    async with aiohttp.ClientSession() as s:
        while time.perf_counter() - t0 < 30:
            async with s.get(f"http://127.0.0.1:{dep.mon}/metrics") as r:
                text = await r.text()
            count = next((float(ln.split()[-1]) for ln in text.splitlines()
                          if ln.startswith(series + " ")), None)
            if count == USER_EVENTS:
                break
            await asyncio.sleep(0.1)
    return count, time.perf_counter() - t0


def _books_match_dump(bal, doc):
    """The replayed books equal the final dump's: free memory (rows past
    the dump's are padding and must be untouched), the non-zero conc cells
    and the health of every registered invoker. Health is read from the
    device books: a replay sets the host registry's health only from
    `reg` records (as the JAX package's does), and the flips ride the
    batches' health rows."""
    free = bal.state.free_mb.cpu().numpy()
    conc = bal.state.conc_free.T.cpu().numpy()  # [N, A]
    n, h = len(doc["free_mb"]), len(doc["healthy"])
    cells = [[int(i), int(j), int(conc[i, j])] for i, j in zip(
        *np.nonzero(conc[:n]))]
    return (free[:n].tolist() == doc["free_mb"] and not free[n:].any()
            and cells == doc["conc_nonzero"] and not conc[n:].any()
            and bal.state.health[:h].cpu().tolist() == doc["healthy"])


def deploy_phase(TB, K):
    """Phase 9: the broker, invoker and controller CLIs as processes."""
    import shutil
    import tempfile
    from openwhisk_tpu_torch.controller.loadbalancer import journal as JN
    from openwhisk_tpu_torch.controller.loadbalancer import timetravel as TT
    work = tempfile.mkdtemp(prefix="chip-smoke-deploy-")
    dep = Deployment(work, [] if DEVICE == "cuda" else ["--device", DEVICE])
    t_phase = time.perf_counter()
    try:
        dep.start()
        try:
            up_s = dep.wait_up()
            traffic = asyncio.run(_deploy_traffic(dep))
            user_events, user_events_s = asyncio.run(_user_events(dep))
        except Exception:
            for name in dep.procs:
                print(f"--- {name} log:\n{dep.log(name)[-3000:]}",
                      file=sys.stderr)
            raise
        finally:
            rcs = dep.stop()
        logs = {n: dep.log(n)[-2000:] for n in dep.procs}
        require(all(rc == 0 for rc in rcs.values()),
                f"deploy: every process exits 0 on SIGTERM: {rcs} {logs}")
        with open(dep.snap) as f:
            doc = json.load(f)
        records = [r for r in JN.PlacementJournal(dep.wal).records(0)
                   if int(r["seq"]) <= doc["journal_seq"]]

        async def replay(device):
            bal = TT.make_offline_balancer(device=device)
            try:
                if device is None:
                    st, rp = _measured_replay(
                        TB, K, bal, lambda: bal.replay_journal(records))
                else:
                    t = time.perf_counter()
                    st = bal.replay_journal(records)
                    rp = dict(s=time.perf_counter() - t)
                return st, rp, _books_match_dump(bal, doc)
            finally:
                await bal.close()

        card_st, card_rp, card_equal = asyncio.run(
            replay(None if DEVICE == "cuda" else DEVICE))
        cpu_st, cpu_rp, cpu_equal = asyncio.run(replay("cpu"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    status, ready = traffic["ready"]
    pstatus, prof = traffic["profile"]
    wstatus, wf = traffic["waterfall"]
    builds = {(b["source"], b["how"]) for b in prof.get("kernel_builds", [])}
    line = dict(
        processes=1 + DEPLOY_INVOKERS + 2, invokers=DEPLOY_INVOKERS,
        invoker_memory_mb=DEPLOY_MEMORY_MB, up_s=up_s,
        fleet_up_s=traffic["fleet_up_s"],
        first_invoke_ms=traffic["first_invoke_ms"],
        invokes=traffic["invokes"], invokes_per_s=traffic["invokes_per_s"],
        http_ms_p50_p99_concurrent=traffic["http_ms_p50_p99_concurrent"],
        http_ms_p50_p99_sequential=traffic["http_ms_p50_p99_sequential"],
        burst=traffic["burst"], launches=traffic["launches"],
        step_ms=prof.get("phases", {}).get("total"),
        # the controller's stages: completion_ack's median holds the bus
        # hops, the invoker process and the sandbox
        waterfall={k: wf.get("budget", {}).get(k) for k in (
            "stage_medians_ms", "e2e_p50_ms", "e2e_p99_ms", "count")},
        kernel_builds=prof.get("kernel_builds"),
        compiles=prof.get("compiles", {}).get("unexpected"),
        ready=ready, rcs=rcs,
        user_events=dict(published=USER_EVENTS, counted=user_events,
                         s=user_events_s),
        final_dump=dict(journal_seq=doc["journal_seq"],
                        registry=len(doc["registry"]),
                        conc_cells=len(doc["conc_nonzero"])),
        replay_card=dict(records=card_st["replayed"],
                         batches=card_st["batches"],
                         parity_mismatches=card_st["parity_mismatches"],
                         books_equal_final_dump=card_equal,
                         batches_per_s=card_st["batches"] / card_rp["s"],
                         **card_rp),
        replay_cpu=dict(backend="cpu", records=cpu_st["replayed"],
                        batches=cpu_st["batches"],
                        parity_mismatches=cpu_st["parity_mismatches"],
                        books_equal_final_dump=cpu_equal, s=cpu_rp["s"]),
        phase_s=time.perf_counter() - t_phase)
    say("deploy", **line)
    lc = traffic["launches"]
    require({k: traffic["launches_before"][k] for k in ("scan", "repair")}
            == {"scan": 0, "repair": 0},
            "deploy: the controller's counts were reset before the traffic")
    require(lc["scan"] > 0 and lc["repair"] > 0 or DEVICE != "cuda",
            f"deploy: the controller launched both kernels: {lc}")
    require(status == 200 and ready["journal"]["attached"],
            f"deploy: /admin/ready answers 200 with the journal: {ready}")
    require(user_events == USER_EVENTS,
            f"deploy: the monitoring service counted the {USER_EVENTS} "
            f"activation events: {user_events}")
    require(pstatus == 200 and prof["compiles"]["unexpected"] == 0,
            "deploy: the kernel profile shows no churn")
    require(wstatus == 200 and wf["finished"] >= traffic["invokes"],
            f"deploy: the waterfall finished every activation: "
            f"{wf.get('finished')}")
    # phase 2's libraries (same sources, same cache key): loaded, not built
    require(DEVICE != "cuda" or builds == {(src, "load")
                                           for src in K.SOURCES},
            f"deploy: the controller loaded every kernel unbuilt: {builds}")
    require(len(doc["registry"]) == DEPLOY_INVOKERS,
            "deploy: the final dump holds the fleet")
    require(card_equal and card_st["parity_mismatches"] == 0
            and card_st["batches"] >= 1,
            f"deploy: the journal replays on the card to the final dump's "
            f"books: {card_st}")
    require(DEVICE != "cuda" or (card_rp["launches"]["scan"] > 0
                                 and card_rp["launches"]["repair"] > 0),
            f"deploy: both kernels ran in the card replay: {card_rp}")
    require(cpu_equal and cpu_st["parity_mismatches"] == 0,
            f"deploy: the journal replays on the CPU to the same books: "
            f"{cpu_st}")
    return line


# ---------------------------------------------------------------- phase 10
#: 10a: three placing controllers on the card in partition mode
AA_CTRLS, AA_PARTS, AA_DEAD = 3, 8, 2
AA_WAVES, AA_SNAP_WAVE, AA_HOT_WAVE, AA_KILL_WAVE = 18, 4, 6, 9
#: single-row publishes an owner after each wave's acks (the scan)
AA_TRICKLE = 2
#: the hot namespace's non-blocking burst, past `spillover_depth`
AA_HOT_ROWS, AA_SPILL_DEPTH = 320, 256
AA_REFUSED = 4


def _launches(K):
    return {"scan": K.schedule_batch_cuda.launches,
            "repair": K.schedule_batch_repair_cuda.launches,
            "release": K.release_batch_cuda.launches}


def _host_state(P, st):
    """A CPU copy of the books, conc as the [N, A] view of [A, N] storage
    as on the card."""
    return P.PlacementState(st.free_mb.cpu().clone(),
                            st.conc_free.T.cpu().clone().T,
                            st.health.cpu().clone())


def _same_state(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


class _ListJournal:
    """A journal over a list of records, as `PlacementJournal.records`."""

    def __init__(self, recs):
        self.recs = recs

    def records(self, after_seq=0):
        return iter([r for r in self.recs if int(r["seq"]) > after_seq])


class _Resolver:
    """The spillover receivers' entity store: the mix's actions by name."""

    def __init__(self, mix):
        self.by_name = {str(a.fully_qualified_name): a for a in mix.actions}

    async def get_action(self, name, rev=None):
        action = self.by_name[name]

        class Doc:
            @staticmethod
            def to_executable():
                return action
        return Doc()


async def _absorb_run(TB, K, P, root):
    """Phase 10a's run (module docstring); returns its numbers and the
    absorbs' inputs for the CPU replays."""
    import os
    from openwhisk_tpu_torch.core import entity as E
    from openwhisk_tpu_torch.controller.loadbalancer import checkpoint as CK
    from openwhisk_tpu_torch.controller.loadbalancer import journal as JN
    from openwhisk_tpu_torch.controller.loadbalancer.membership import \
        ControllerMembership
    from openwhisk_tpu_torch.controller.loadbalancer.spillover import (
        SpilloverReceiver, SpilloverSender)
    from openwhisk_tpu_torch.utils.partitions import PartitionRing
    errors = []

    class Log:
        def error(self, _tid, msg, *_):
            errors.append(msg)

        def warn(self, *_):
            pass

        def info(self, *_):
            pass

    def wal(i):
        return os.path.join(root, "wal", f"ctrl{i}")

    def snap(i):
        return os.path.join(root, f"bal.snap.ctrl{i}")

    ring = PartitionRing(AA_PARTS)
    fleet = Fleet(seed=17)
    fleet.seen = []
    fleet.start()
    bals, members, receivers, absorbs, gains = [], [], [], [], []
    dead = set()

    def on_partitions_for(i):
        async def on_partitions(gained, lost):
            # the controller CLI's partition callback, each absorb measured
            lb = bals[i]
            for pid, epoch, *_rest in lost:
                lb.set_partition_leadership(pid, epoch, False)
            by_prev = {}
            for pid, epoch, prev in gained:
                gains.append((i, pid, epoch, prev, time.perf_counter()))
                by_prev.setdefault(prev, []).append((pid, epoch))
            for prev, items in by_prev.items():
                pids = [p for p, _ in items]
                if prev is not None:
                    try:
                        with open(snap(prev)) as f:
                            snap_doc = json.load(f)
                    except (OSError, ValueError):
                        snap_doc = None
                    from_seq = int((snap_doc or {}).get("journal_seq", 0))
                    records = list(JN.PlacementJournal(wal(prev)).records(
                        from_seq))
                    before = _host_state(P, lb.state)
                    l0 = _launches(K)
                    t0 = time.perf_counter()
                    stats = lb.absorb_partitions(
                        pids, JN.PlacementJournal(wal(prev)),
                        snap_doc=snap_doc)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    l1 = _launches(K)
                    absorbs.append(dict(
                        ctrl=i, prev=prev, pids=sorted(pids), stats=stats,
                        ms=ms, launches={k: l1[k] - l0[k] for k in l0},
                        before=before, after=_host_state(P, lb.state),
                        records=records, snap_doc=snap_doc,
                        t=time.perf_counter()))
                for pid, epoch in items:
                    lb.set_partition_leadership(pid, epoch, True)
        return on_partitions

    t_phase = time.perf_counter()
    for i in range(AA_CTRLS):
        bal = TB.TpuBalancer(
            fleet.provider, E.ControllerInstanceId(str(i)), logger=Log(),
            managed_fraction=0.9, blackbox_fraction=0.1, max_batch=MAX_BATCH,
            action_slots=A, initial_pad=64,
            device=None if DEVICE == "cuda" else DEVICE)
        # the run is shorter than a ping round trip matters: no re-pings
        bal.supervision.ping_timeout = 3600.0
        bal.set_partition_mode(ring)
        bal.spillover_depth = AA_SPILL_DEPTH
        bal.attach_journal(JN.PlacementJournal(wal(i)))
        await bal.start()
        bals.append(bal)
    t0 = time.perf_counter()
    await fleet.ping(bals[0].supervision, list(range(N_INV)))
    for bal in bals:
        while not (len(bal._registry) == N_INV and all(bal._healthy)):
            require(time.perf_counter() - t0 < 120.0,
                    "absorb: every balancer registered the fleet")
            await asyncio.sleep(0.01)
    register_s = time.perf_counter() - t0
    for i, bal in enumerate(bals):
        lb = bal
        members.append(ControllerMembership(
            fleet.provider, E.ControllerInstanceId(str(i)), bal, ring=ring,
            on_partitions=on_partitions_for(i),
            load_hint=lambda lb=lb: float(lb.total_active_activations
                                          + len(lb._pending))))
        members[-1].start()
    t0 = time.perf_counter()
    while not (sum(len(m.owned_partitions) for m in members) == AA_PARTS
               and all(m.owned_partitions for m in members)
               and all(b.cluster_size == AA_CTRLS for b in bals)):
        require(time.perf_counter() - t0 < 60.0,
                "absorb: the ring's ownership converged")
        await asyncio.sleep(0.02)
    claim_s = time.perf_counter() - t0
    mix = ActionMix(seed=19, ctrl=E.ControllerInstanceId("0"))
    resolver = _Resolver(mix)
    for i, bal in enumerate(bals):
        bal._arm_flush()  # the registration's health flips, then traffic
        await _drain_front(bal)
        bal.spillover_sink = SpilloverSender(fleet.provider, members[i])
        receivers.append(SpilloverReceiver(
            fleet.provider, E.ControllerInstanceId(str(i)), bal, resolver))
        receivers[-1].start()
    owned_at_start = {i: sorted(m.owned_partitions)
                      for i, m in enumerate(members)}

    def owners():
        own = {}
        for i, m in enumerate(members):
            if i not in dead:
                for pid in m.owned_partitions:
                    own[pid] = i
        require(len(own) == AA_PARTS, f"absorb: every partition owned: {own}")
        return own

    def routed(pairs, own):
        by = {}
        for a, m in pairs:
            i = own[ring.partition_of(str(m.user.namespace.name))]
            m.root_controller_index = E.ControllerInstanceId(str(i))
            by.setdefault(i, []).append((a, m))
        return by

    placed_outs, refused, spilled_outs = [], [], []
    K_before = _launches(K)
    t_kill = kill = None
    prev = []
    hot = {}
    t_traffic = time.perf_counter()
    for w in range(AA_WAVES):
        await fleet.ack_due(w)
        if w == AA_SNAP_WAVE:
            for i, bal in enumerate(bals):
                CK.write_snapshot(bal, snap(i))
        if w == AA_KILL_WAVE:
            # "kill" controller AA_DEAD: its membership falls silent (no
            # leave), its receiver and balancer stop with no final dump;
            # the survivors drop it from their view and claim its
            # partitions at higher epochs, absorbing its journal tail
            await asyncio.gather(*prev, return_exceptions=True)
            dm = members[AA_DEAD]
            kill = dict(partitions=sorted(dm.owned_partitions),
                        epochs={p: bals[AA_DEAD].partition_epochs.get(p)
                                for p in dm.owned_partitions},
                        journal_seq=bals[AA_DEAD]._journal_seq)
            await dm._ticker.stop()
            await dm._feed.stop()
            await receivers[AA_DEAD].stop()
            await bals[AA_DEAD].close()
            dead.add(AA_DEAD)
            t_kill = time.perf_counter()
            for i, m in enumerate(members):
                if i not in dead:
                    m._last_seen.pop(AA_DEAD, None)
            want = set(kill["partitions"])
            while True:
                got = set()
                for i, m in enumerate(members):
                    if i not in dead:
                        got |= set(m.owned_partitions)
                gainers = {g[0] for g in gains if g[3] == AA_DEAD}
                done = {a["ctrl"] for a in absorbs if a["prev"] == AA_DEAD}
                if got == set(range(AA_PARTS)) and gainers and \
                        gainers <= done:
                    break
                require(time.perf_counter() - t_kill < 60.0,
                        f"absorb: the survivors claimed {sorted(got)}")
                await asyncio.sleep(0.01)
            kill["handoff_s"] = time.perf_counter() - t_kill
        own = owners()
        pairs = mix.pairs(MAX_BATCH)
        outs = []
        for i, ps in routed(pairs, own).items():
            outs += bals[i].publish_many(ps)
        placed_outs += outs
        if w == 1:
            # rows published to a non-owner: refused with the reference's
            # text, nothing placed
            for a, m in mix.pairs(AA_REFUSED):
                pid = ring.partition_of(str(m.user.namespace.name))
                wrong = next(i for i in range(AA_CTRLS) if own[pid] != i)
                refused.append((pid, m.activation_id.asString,
                                bals[wrong].publish_many([(a, m)])[0]))
        if w == AA_HOT_WAVE:
            # one hot namespace's non-blocking burst: its tail past the
            # owner's spillover_depth forwards to the least-loaded peer
            a, m0 = mix.pairs(1)[0]
            ns = str(m0.user.namespace.name)
            i_hot = own[ring.partition_of(ns)]
            hot_pairs = []
            for k in range(AA_HOT_ROWS):
                m = mix.M.ActivationMessage(
                    mix.Tx(f"hot{k}"), a.fully_qualified_name, "1-a",
                    m0.user, E.ActivationId.generate(),
                    E.ControllerInstanceId(str(i_hot)), False, {})
                hot_pairs.append((a, m))
            spilled0 = bals[i_hot].spilled_rows
            spilled_outs = bals[i_hot].publish_many(hot_pairs)
            hot = dict(ctrl=i_hot, ns=ns, partition=ring.partition_of(ns),
                       rows=AA_HOT_ROWS,
                       spilled=bals[i_hot].spilled_rows - spilled0)
            placed_outs += spilled_outs
        await asyncio.gather(*prev, return_exceptions=True)
        prev = outs
        # the trickle: single-row steps once a step took the releases
        for i in range(AA_CTRLS):
            if i in dead:
                continue
            for _ in range(AA_TRICKLE):
                while True:
                    a, m = mix.pairs(1)[0]
                    if own[ring.partition_of(str(m.user.namespace.name))] \
                            == i:
                        break
                m.root_controller_index = E.ControllerInstanceId(str(i))
                out = asyncio.ensure_future(bals[i].publish(a, m))
                placed_outs.append(out)
                await asyncio.gather(out, return_exceptions=True)
    await asyncio.gather(*prev, return_exceptions=True)
    traffic_s = time.perf_counter() - t_traffic
    placed = sum(1 for o in placed_outs if o.done() and not o.cancelled()
                 and o.exception() is None)
    t0 = time.monotonic()
    while fleet.received < placed:
        require(time.monotonic() - t0 < 60.0,
                f"absorb: the fleet received {fleet.received} of {placed}")
        await asyncio.sleep(0.01)
    await fleet.ack_due(AA_WAVES, everything=True)
    for i, bal in enumerate(bals):
        if i not in dead:
            await _drain_front(bal)
    K_after = _launches(K)
    failed = [o.exception() for o in placed_outs
              if o.cancelled() or o.exception() is not None]
    refusals = [(pid, o.exception()) for pid, _aid, o in refused]
    # every activation dispatched once: the fleet saw each id once
    seen = {}
    for m in fleet.seen:
        seen[m.activation_id.asString] = seen.get(
            m.activation_id.asString, 0) + 1
    late = next((m for m in fleet.seen
                 if m.root_controller_index.name == str(AA_DEAD)
                 and m.fence_part in (kill or {}).get("epochs", {})), None)
    fresh = None if late is None else next(
        (m for m in fleet.seen if m.fence_part == late.fence_part
         and m.fence_epoch is not None
         and m.fence_epoch > late.fence_epoch), None)
    out = dict(
        register_s=register_s, claim_s=claim_s, traffic_s=traffic_s,
        owned_at_start=owned_at_start, kill=kill, hot=hot,
        rows=len(placed_outs), failed=len(failed),
        failed_texts=sorted({str(e) for e in failed})[:3],
        refusals=[(pid, type(e).__name__, str(e)) for pid, e in refusals],
        dispatched=len(seen), dispatched_twice=sum(c > 1 for c in
                                                   seen.values()),
        refused_dispatched=sum(aid in seen for _p, aid, _o in refused),
        spill_received=sum(r.received for r in receivers),
        spill_refused=sum(r.refused for r in receivers),
        gains=gains, t_kill=t_kill, errors=errors[:5],
        launches={k: K_after[k] - K_before[k] for k in K_after},
        owned_at_end={i: sorted(m.owned_partitions)
                      for i, m in enumerate(members) if i not in dead},
        epochs_at_end={i: {p: bals[i].partition_epochs.get(p)
                           for p in members[i].owned_partitions}
                       for i in range(AA_CTRLS) if i not in dead},
        late=late, fresh=fresh, phase_s=time.perf_counter() - t_phase)
    for i, m in enumerate(members):
        if i not in dead:
            await m.stop()
    for i, r in enumerate(receivers):
        if i not in dead:
            await r.stop()
    for i, bal in enumerate(bals):
        if i not in dead:
            await bal.close()
        if bal.journal is not None:
            await asyncio.to_thread(bal.journal.close)
    await fleet.stop()
    return out, absorbs


async def _fence_check(late, fresh):
    """The port's invoker fence on the run's own messages: the survivor's
    newer-epoch dispatch for the partition, then the dead owner's late one
    (its old epoch): the late one is discarded."""
    from openwhisk_tpu_torch.containerpool import ContainerPoolConfig
    from openwhisk_tpu_torch.core import entity as E
    from openwhisk_tpu_torch.database import (ArtifactActivationStore,
                                              EntityStore,
                                              MemoryArtifactStore)
    from openwhisk_tpu_torch.invoker.reactive import InvokerReactive
    from openwhisk_tpu_torch.messaging import memory as mem

    class FactoryStub:
        async def cleanup(self):
            pass

    class FeedStub:
        def processed(self):
            pass

    store = MemoryArtifactStore()
    inv = InvokerReactive(
        E.InvokerInstanceId(0, user_memory=E.MB(MEM_MB)),
        mem.MemoryMessagingProvider(), EntityStore(store),
        ArtifactActivationStore(store), FactoryStub(),
        pool_config=ContainerPoolConfig(user_memory=E.MB(MEM_MB)))
    await inv._process(fresh.serialize(), FeedStub())
    fresh_discards = inv.fenced_discards
    await inv._process(late.serialize(), FeedStub())
    return dict(partition=late.fence_part, late_epoch=late.fence_epoch,
                fresh_epoch=fresh.fence_epoch,
                discarded_fresh=fresh_discards,
                discarded_late=inv.fenced_discards - fresh_discards)


def absorb_phase(TB, K, P):
    """Phase 10a: active/active absorb at full width, in one process."""
    import shutil
    import tempfile
    from openwhisk_tpu_torch.core import entity as E
    from openwhisk_tpu_torch.messaging.memory import MemoryMessagingProvider
    root = tempfile.mkdtemp(prefix="chip-smoke-absorb-")
    try:
        run, absorbs = asyncio.run(_absorb_run(TB, K, P, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(run["late"] is not None and run["fresh"] is not None,
            "absorb: a dead owner's dispatch and a survivor's later one "
            "for the same partition")
    fence = asyncio.run(_fence_check(run["late"], run["fresh"]))
    # each absorb once more on the CPU: the same tail onto the same
    # pre-absorb books through the plain versions
    rows = []
    for ab in absorbs:
        async def cpu_replay(ab=ab):
            cpu = TB.TpuBalancer(
                MemoryMessagingProvider(), E.ControllerInstanceId("9"),
                device="cpu", managed_fraction=0.9, blackbox_fraction=0.1,
                max_batch=MAX_BATCH, action_slots=A, initial_pad=N_PAD)
            try:
                cpu._install_state(P.PlacementState(
                    *(t.clone() for t in ab["before"])))
                t0 = time.perf_counter()
                st = cpu.absorb_partitions(ab["pids"],
                                           _ListJournal(ab["records"]),
                                           snap_doc=ab["snap_doc"])
                return st, time.perf_counter() - t0, _same_state(
                    _host_state(P, cpu.state), ab["after"])
            finally:
                await cpu.close()

        cst, cpu_s, equal = asyncio.run(cpu_replay())
        st = ab["stats"]
        batches = [r for r in ab["records"] if r["t"] == "batch"
                   and set(r.get("parts") or ()) & set(ab["pids"])]
        rows.append(dict(
            ctrl=ab["ctrl"], prev=ab["prev"], partitions=ab["pids"],
            ms=ab["ms"], replayed=st.get("replayed"),
            batches=st.get("batches"), filtered_out=st.get("filtered_out"),
            stale_epoch_dropped=st.get("stale_epoch_dropped"),
            parity_mismatches=st.get("parity_mismatches"),
            skipped=st.get("skipped"), tail_records=len(ab["records"]),
            batches_per_partition=len(batches) / len(ab["pids"]),
            records_per_partition=st.get("replayed", 0) / len(ab["pids"]),
            launches=ab["launches"], books_equal_cpu_replay=equal,
            cpu_stats_equal=({k: cst.get(k) for k in st}
                             == {k: st.get(k) for k in st}),
            cpu_s=cpu_s, since_kill_s=ab["t"] - run["t_kill"]))
    # ownership claims the kill does not explain: the 5 s heartbeat risk
    after = [g for g in run["gains"] if g[4] >= run["t_kill"]]
    expected = [g for g in after if g[3] == AA_DEAD]
    line = dict(
        controllers=AA_CTRLS, partitions=AA_PARTS, invokers=N_INV, n_pad=N_PAD,
        a=A, register_s=run["register_s"], claim_s=run["claim_s"],
        traffic_s=run["traffic_s"], owned_at_start=run["owned_at_start"],
        killed=AA_DEAD, kill=run["kill"], absorbs=rows,
        owned_at_end=run["owned_at_end"], epochs_at_end=run["epochs_at_end"],
        rows=run["rows"], failed=run["failed"],
        dispatched=run["dispatched"],
        dispatched_twice=run["dispatched_twice"],
        refusals=run["refusals"], refused_dispatched=run["refused_dispatched"],
        hot=run["hot"], spill_received=run["spill_received"],
        spill_refused=run["spill_refused"], fence=fence,
        claims_after_kill=len(after),
        unexpected_claims=len(after) - len(expected),
        launches=run["launches"], errors=run["errors"],
        phase_s=run["phase_s"])
    say("absorb", **line)
    require(not run["errors"], f"absorb: no balancer logged an error: "
                               f"{run['errors']}")
    require(rows and {r["ctrl"] for r in rows} <= set(range(AA_CTRLS))
            - {AA_DEAD} and all(r["prev"] == AA_DEAD for r in rows),
            f"absorb: the survivors absorbed the dead owner: {rows}")
    require(set().union(*(r["partitions"] for r in rows))
            == set(run["kill"]["partitions"]),
            "absorb: every partition of the dead owner was absorbed")
    for r in rows:
        require(r["skipped"] is None, f"absorb: no absorb skipped: {r}")
        require(r["books_equal_cpu_replay"] and r["cpu_stats_equal"],
                f"absorb: the card's absorb equals the CPU replay: {r}")
        require(r["batches"] >= 1, f"absorb: batches replayed: {r}")
        require(DEVICE != "cuda" or sum(r["launches"].values()) > 0,
                f"absorb: the absorb launched the kernels: {r}")
    tot = {k: sum(r["launches"][k] for r in rows) for k in ("scan",
                                                            "repair")}
    require(DEVICE != "cuda" or (tot["scan"] > 0 and tot["repair"] > 0),
            f"absorb: the absorbs launched both kernels: {tot}")
    owned = set().union(*map(set, run["owned_at_end"].values()))
    require(owned == set(range(AA_PARTS)),
            f"absorb: the survivors own every partition: {owned}")
    for pid, ep in run["kill"]["epochs"].items():
        now_ep = next(e[pid] for e in run["epochs_at_end"].values()
                      if pid in e)
        require(now_ep > ep, f"absorb: partition {pid} at a higher epoch")
    require(run["failed"] == 0 and run["dispatched_twice"] == 0,
            f"absorb: every row resolved, each dispatched once: "
            f"{run['failed']} failed {run['failed_texts']}, "
            f"{run['dispatched_twice']} twice")
    require(run["dispatched"] == run["rows"] and
            run["refused_dispatched"] == 0,
            f"absorb: {run['dispatched']} dispatched of {run['rows']} rows")
    require(len(run["refusals"]) == AA_REFUSED and all(
        t == "LoadBalancerException"
        and e == f"partition {p} is owned by another controller"
        for p, t, e in run["refusals"]),
        f"absorb: a non-owner refuses with the reference's text: "
        f"{run['refusals']}")
    require(run["hot"]["spilled"] > 0 and run["spill_received"]
            == run["hot"]["spilled"] and run["spill_refused"] == 0,
            f"absorb: the hot tail spilled to a peer: {run['hot']}")
    require(fence["discarded_fresh"] == 0 and fence["discarded_late"] == 1,
            f"absorb: the invoker fence discards the late batch: {fence}")
    return line


#: 10b/10c: the deployment's processes on localhost (the broker and the
#: invokers are shared by the three controller sets, each set with its own
#: controller instance ids and its own edge)
HA_INVOKERS, HA_PARTS, HA_TENANTS = 4, 8, 16
HA_RATE, HA_DURATION_S, HA_KILL_S = 10.0, 12.0, 4.0
HA_TIMEOUT_S = 90.0
AA_INSTANCES, AS_INSTANCES, FUNNEL_INSTANCES = (0, 1, 2), (3, 4), (5, 6, 7)
AA_KILLED = 1
FUNNEL_DEPTH, FUNNEL_BURST, FUNNEL_BLOCKING, FUNNEL_NONBLOCKING = \
    64, 160, 200, 64
#: one file per execution: a double execution leaves two files for one n
EFFECT_CODE = (
    "import os, uuid\n"
    "def main(a):\n"
    "    p = os.path.join(a['dir'], '%s-%s' % (a['n'], uuid.uuid4().hex))\n"
    "    open(p, 'w').close()\n"
    "    return {'n': a['n']}\n")


class HaDeployment(Deployment):
    """Phase 10's processes: the broker and HA_INVOKERS invokers once, then
    controller sets started and stopped in turn, each controller through
    the CLI (`--deploy-controller` for a placing role, so its launch
    counts can be read), each set behind its own edge."""

    def __init__(self, work):
        super().__init__(work)
        self.effects = __import__("os").path.join(work, "effects")
        __import__("os").makedirs(self.effects)

    def start_base(self):
        bus = f"127.0.0.1:{self.bus}"
        self._start("broker", ["-m", "openwhisk_tpu_torch.messaging",
                               "--port", str(self.bus)])
        for i in range(HA_INVOKERS):
            self._start(f"invoker{i}", [
                "-m", "openwhisk_tpu_torch.invoker", "--bus", bus,
                "--db", self.db, "--unique-name", f"ha-{i}",
                "--memory", str(DEPLOY_MEMORY_MB)])

    def start_controller(self, inst, port, args, env, role="all"):
        """A controller through the CLI's `main()` under
        `--deploy-controller` (launch counts and whether torch initialized
        CUDA in the process, on SIGUSR1); a frontend gets no device
        argument."""
        import os
        name = f"controller{inst}"
        dev = ([] if DEVICE == "cuda" or role == "frontend"
               else ["--device", DEVICE])
        self._start(name, [__file__, "--deploy-controller",
                           os.path.join(self.work, f"{name}.json"),
                           "--bus", f"127.0.0.1:{self.bus}", "--db", self.db,
                           "--port", str(port), "--instance", str(inst),
                           "--role", role, "--balancer", "tpu", *args, *dev],
                    env=env)
        return name

    def start_edge(self, name, ports, env=None):
        self._start(name, ["-m", "openwhisk_tpu_torch.edge", "--port",
                           str(self.api), "--controllers",
                           *[f"http://127.0.0.1:{p}" for p in ports]],
                    env=env)

    def wait_for(self, names, timeout=HA_TIMEOUT_S):
        marks = {"broker": "listening on", "edge": "edge proxy on"}
        up = {}
        t0 = time.perf_counter()
        while len(up) < len(names):
            for name in names:
                proc, _log = self.procs[name]
                mark = next((v for k, v in marks.items()
                             if name.startswith(k)),
                            " up on :" if name.startswith("controller")
                            else ") up")
                if name not in up and mark in self.log(name):
                    up[name] = time.perf_counter() - self.started[name]
                require(proc.poll() is None,
                        f"ha: {name} exited {proc.returncode}: "
                        f"{self.log(name)[-2000:]}")
            require(time.perf_counter() - t0 < timeout,
                    f"ha: {sorted(set(names) - set(up))} not up")
            time.sleep(0.05)
        return up

    def launches_of(self, name, sig):
        import os
        return _signal_counts(self.procs[name][0],
                              os.path.join(self.work, f"{name}.json"), sig,
                              f"ha: {name}")

    def kill(self, name):
        proc, log = self.procs[name]
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)

    def stop_set(self, names):
        rcs = {}
        for name in names:
            proc, log = self.procs[name]
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for name in names:
            proc, log = self.procs[name]
            try:
                rcs[name] = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                rcs[name] = proc.wait()
            if not log.closed:
                log.close()
        return rcs

    def doubles(self):
        import os
        seen = {}
        for f in os.listdir(self.effects):
            n = f.split("-", 1)[0]
            seen[n] = seen.get(n, 0) + 1
        return len(seen), sum(c > 1 for c in seen.values())


def _tenants():
    """HA_TENANTS identities whose namespaces cover every partition of the
    ring, two a partition."""
    from openwhisk_tpu_torch.core import entity as E
    from openwhisk_tpu_torch.utils.partitions import PartitionRing
    ring = PartitionRing(HA_PARTS)
    per = {p: [] for p in range(HA_PARTS)}
    k = 0
    while any(len(v) < HA_TENANTS // HA_PARTS for v in per.values()):
        ns = f"tenant{k}"
        p = ring.partition_of(ns)
        if len(per[p]) < HA_TENANTS // HA_PARTS:
            per[p].append(ns)
        k += 1
    names = sorted(ns for v in per.values() for ns in v)
    return ring, [E.Identity.generate(ns) for ns in names]


async def _seed_tenants(db, idents):
    from openwhisk_tpu_torch.core.entity import WhiskAuthRecord
    from openwhisk_tpu_torch.database import AuthStore, SqliteArtifactStore
    store = SqliteArtifactStore(db)
    auth = AuthStore(store)
    for ident in idents:
        await auth.put(WhiskAuthRecord(ident.subject, [ident.namespace],
                                       [ident.authkey]))
    await store.close()


def _basic(ident=None):
    import aiohttp
    from openwhisk_tpu_torch import standalone as S
    if ident is None:
        return aiohttp.BasicAuth(S.GUEST_UUID, S.GUEST_KEY)
    u, _, k = ident.authkey.compact.partition(":")
    return aiohttp.BasicAuth(u, k)


async def _json_get(s, url, auth=None):
    import aiohttp
    try:
        async with s.get(url, auth=auth or _basic()) as r:
            return r.status, await r.json(content_type=None)
    except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
        return 0, {}


async def _fleet_up(s, port, timeout=HA_TIMEOUT_S):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        st, body = await _json_get(s, f"http://127.0.0.1:{port}/invokers")
        if st == 200 and sum(v == "up" for v in body.values()) \
                == HA_INVOKERS:
            return time.perf_counter() - t0
        await asyncio.sleep(0.2)
    raise RuntimeError(f"ha: the fleet is up at :{port}")


def _owned_parts(doc):
    return {p["partition"]: p["epoch"] for p in doc.get("partitions", [])
            if p["role"] == "active"}


async def _effect_invoke(s, base, ident, n, dep):
    """One blocking invoke of the effect action, no retry: (ok, ms)."""
    import aiohttp
    t = time.perf_counter()
    try:
        async with s.post(f"{base}/namespaces/_/actions/fx?blocking=true"
                          "&result=true", auth=_basic(ident),
                          json={"n": n, "dir": dep.effects}) as r:
            body = await r.json(content_type=None)
            ok = r.status == 200 and body.get("n") == n
    except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
        ok = False
    return ok, (time.perf_counter() - t) * 1e3


async def _open_loop_burst(s, base, idents, dep, n0, kill, chaos,
                           after_kill=None):
    """HA_RATE invokes a second for HA_DURATION_S over the tenants, open
    loop and without retries; `kill()` runs HA_KILL_S in, and `await
    after_kill()` right after it. `chaos` gets the kill's `chaos_kill`
    mark: `time.monotonic()` (CLOCK_MONOTONIC, one clock for every process
    of the host, as the controllers' event logs stamp `mono`) and the wall
    clock. Returns the rows (tenant, sent, done, ok, ms) and the kill's
    time."""
    rows, t_kill = [], [None]
    t0 = time.perf_counter()

    async def one(i):
        ident = idents[i % len(idents)]
        sent = time.perf_counter()
        ok, ms = await _effect_invoke(s, base, ident, n0 + i, dep)
        rows.append((i % len(idents), sent, time.perf_counter(), ok, ms))

    async def killer():
        await asyncio.sleep(HA_KILL_S)
        t_kill[0] = time.perf_counter()
        chaos.update(kind="chaos_kill", mono=time.monotonic(),
                     ts=time.time(), seq=-1)
        await asyncio.to_thread(kill)
        if after_kill is not None:
            await after_kill()

    tasks = [asyncio.ensure_future(killer())]
    for i in range(int(HA_RATE * HA_DURATION_S)):
        delay = t0 + i / HA_RATE - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.ensure_future(one(i)))
    await asyncio.gather(*tasks)
    return rows, t_kill[0], time.perf_counter() - t0


def _burst_report(rows, t_kill, wall_s, tenants_of_dead):
    ok = [r for r in rows if r[3]]
    before = [r[4] for r in ok if r[2] < t_kill]
    after_dead = [r for r in ok if r[1] > t_kill and r[0] in tenants_of_dead]
    first = min((r[2] for r in after_dead), default=None)
    after = [r[4] for r in ok if first is not None and r[1] >= first]
    served_after = {r[0] for r in ok if r[1] > t_kill}
    return dict(
        offered=len(rows), completed=len(ok), wall_s=wall_s,
        invokes_per_s=len(ok) / wall_s,
        failed_during_failover=sum(1 for r in rows if not r[3]),
        downtime_s=None if first is None else first - t_kill,
        http_ms_p50_p99_before=_percentiles(before),
        http_ms_p50_p99_after=_percentiles(after),
        tenants_served_after_kill=len(served_after))


async def _put_effect_action(s, base, idents):
    for ident in [None, *idents]:
        async with s.put(f"{base}/namespaces/_/actions/fx?overwrite=true",
                         auth=_basic(ident), json={"exec": {
                             "kind": "python:3", "code": EFFECT_CODE},
                             "limits": {"memory": DEPLOY_ACTION_MB}}) as r:
            require(r.status == 200, f"ha: PUT fx {r.status} "
                                     f"{await r.text()}")


#: the fleet observatory's merged views read in 10b before the kill
FLEET_VIEWS = ("metrics", "slo", "waterfall", "host", "timeline")


async def _own_counts(s, ports):
    """Each controller's own SLO count and finished waterfall rows, read
    directly."""
    slo, fin = [], []
    for p in ports:
        st, d = await _json_get(s, f"http://127.0.0.1:{p}/admin/slo")
        wst, w = await _json_get(
            s, f"http://127.0.0.1:{p}/admin/latency/waterfall")
        require(st == 200 and wst == 200,
                f"fleet: :{p} /admin/slo {st}, waterfall {wst}")
        slo.append(d["global"]["count"])
        fin.append(w["finished"])
    return slo, fin


async def _fleet_views(s, ports):
    """10b's fleet read, no traffic in flight: each /admin/fleet/* view
    of FLEET_VIEWS from the first controller with the run's credential
    (each GET timed on this clock), between two direct reads of every
    member's own SLO count and waterfall finished count."""
    slo0, fin0 = await _own_counts(s, ports)
    views, ms = {}, {}
    for v in FLEET_VIEWS:
        t = time.perf_counter()
        views[v] = await _json_get(
            s, f"http://127.0.0.1:{ports[0]}/admin/fleet/{v}")
        ms[v] = (time.perf_counter() - t) * 1e3
    slo1, fin1 = await _own_counts(s, ports)
    return dict(
        ms=ms, status={v: st for v, (st, _b) in views.items()},
        members={v: len(b.get("members", [])) for v, (_st, b)
                 in views.items()},
        missing={v: b.get("members_missing") for v, (_st, b)
                 in views.items() if v != "timeline"},
        slo_merged=views["slo"][1].get("global", {}).get("count"),
        slo_members=slo0, slo_members_after=slo1,
        finished_merged=views["waterfall"][1].get("finished"),
        finished_members=fin0, finished_members_after=fin1,
        timeline_events=views["timeline"][1].get("count"))


async def _failover_phases(s, port, chaos):
    """The merged timeline of the controller on `port` from the chaos mark
    on, with the mark, split by `reconstruct_phases` (marks before the
    kill must not open the outage)."""
    from openwhisk_tpu_torch.controller.monitoring import reconstruct_phases
    st, tl = await _json_get(
        s, f"http://127.0.0.1:{port}/admin/fleet/timeline")
    require(st == 200, f"fleet: the survivor's timeline answers {st}")
    events = [e for e in tl.get("events", [])
              if e.get("mono", 0.0) >= chaos["mono"]]
    out = reconstruct_phases([dict(chaos)] + events)
    out["kinds_after_kill"] = sorted({e.get("kind") for e in events})
    return out


async def _aa_traffic(dep, ports, idents, ring):
    import aiohttp
    conn = aiohttp.TCPConnector(limit=256)
    out = {}
    async with aiohttp.ClientSession(connector=conn, timeout=aiohttp
                                     .ClientTimeout(total=30)) as s:
        for p in ports:
            await _fleet_up(s, p)
        t0 = time.perf_counter()
        while True:
            rs = {i: await _json_get(s, f"http://127.0.0.1:{p}/admin/ready")
                  for i, p in zip(AA_INSTANCES, ports)}
            if all(st == 200 for st, _d in rs.values()) and sum(
                    len(_owned_parts(d)) for _st, d in rs.values()) \
                    == HA_PARTS:
                break
            require(time.perf_counter() - t0 < HA_TIMEOUT_S,
                    f"ha: the ring's ownership converged: {rs}")
            await asyncio.sleep(0.2)
        out["claim_s"] = time.perf_counter() - t0
        before = {i: _owned_parts(d) for i, (_st, d) in rs.items()}
        dead_parts = before[AA_KILLED]
        tenants_of_dead = {k for k, ident in enumerate(idents)
                           if ring.partition_of(str(ident.namespace.name))
                           in dead_parts}
        base = f"http://127.0.0.1:{dep.api}/api/v1"
        await _put_effect_action(s, base, idents)
        for k, ident in enumerate(idents):  # warm: each tenant served once
            ok, _ms = await _effect_invoke(s, base, ident, 900_000 + k, dep)
            require(ok, f"ha: tenant {k} served before the burst")
        out["fleet"] = await _fleet_views(s, ports)
        survivors = [f"controller{i}" for i in AA_INSTANCES
                     if i != AA_KILLED]
        for name in survivors:
            dep.launches_of(name, signal.SIGUSR2)
        chaos = {}

        async def dead_in_directory():
            # the dead controller is still in the survivors' directory
            # (membership's 5 s silence window): the merged view labels it
            t = time.perf_counter()
            st, body = await _json_get(
                s, f"http://127.0.0.1:{ports[0]}/admin/fleet/metrics")
            out["missing_after_kill"] = dict(
                status=st, members_missing=body.get("members_missing"),
                members=len(body.get("members", [])),
                ms=(time.perf_counter() - t) * 1e3,
                s_after_kill=time.monotonic() - chaos["mono"])

        rows, t_kill, wall = await _open_loop_burst(
            s, base, idents, dep, 0,
            lambda: dep.kill(f"controller{AA_KILLED}"), chaos,
            dead_in_directory)
        out["burst"] = _burst_report(rows, t_kill, wall, tenants_of_dead)
        out["phases"] = await _failover_phases(s, ports[0], chaos)
        out["confirm"] = [(await _effect_invoke(
            s, base, ident, 800_000 + k, dep))[0]
            for k, ident in enumerate(idents)]
        t0 = time.perf_counter()
        while True:
            rs = {i: await _json_get(s, f"http://127.0.0.1:{p}/admin/ready")
                  for i, p in zip(AA_INSTANCES, ports) if i != AA_KILLED}
            owned = {}
            for _st, d in rs.values():
                owned.update(_owned_parts(d))
            if set(owned) == set(range(HA_PARTS)) or \
                    time.perf_counter() - t0 > 10:
                break
            await asyncio.sleep(0.2)
        out.update(before=before, dead_parts=dead_parts, after=owned,
                   ready={i: [st, d.get("mode"), d.get("owned_partitions")]
                          for i, (st, d) in rs.items()},
                   tenants_of_dead=sorted(tenants_of_dead),
                   launches={n: dep.launches_of(n, signal.SIGUSR1)
                             for n in survivors})
    return out


async def _as_traffic(dep, ports, idents):
    import aiohttp
    conn = aiohttp.TCPConnector(limit=256)
    out = {}
    async with aiohttp.ClientSession(connector=conn, timeout=aiohttp
                                     .ClientTimeout(total=30)) as s:
        for p in ports:
            await _fleet_up(s, p)
        t0 = time.perf_counter()
        while True:
            rs = {i: await _json_get(s, f"http://127.0.0.1:{p}/admin/ready")
                  for i, p in zip(AS_INSTANCES, ports)}
            active = [i for i, (st, d) in rs.items() if st == 200
                      and d.get("role") == "active"]
            if len(active) == 1:
                break
            require(time.perf_counter() - t0 < HA_TIMEOUT_S,
                    f"ha: a leader emerged: {rs}")
            await asyncio.sleep(0.2)
        out["elect_s"] = time.perf_counter() - t0
        act = active[0]
        standby = next(i for i in AS_INSTANCES if i != act)
        base = f"http://127.0.0.1:{dep.api}/api/v1"
        for k, ident in enumerate(idents):
            ok, _ms = await _effect_invoke(s, base, ident, 700_000 + k, dep)
            require(ok, f"ha: tenant {k} served by the active")
        dep.launches_of(f"controller{standby}", signal.SIGUSR2)
        chaos = {}
        rows, t_kill, wall = await _open_loop_burst(
            s, base, idents, dep, 100_000,
            lambda: dep.kill(f"controller{act}"), chaos)
        out["burst"] = _burst_report(rows, t_kill, wall,
                                     set(range(len(idents))))
        out["phases"] = await _failover_phases(
            s, ports[AS_INSTANCES.index(standby)], chaos)
        out["confirm"] = [(await _effect_invoke(
            s, base, ident, 600_000 + k, dep))[0]
            for k, ident in enumerate(idents)]
        st, doc = await _json_get(
            s, f"http://127.0.0.1:{ports[AS_INSTANCES.index(standby)]}"
               "/admin/ready")
        out.update(active=act, standby=standby,
                   ready=[st, {k: doc.get(k) for k in (
                       "mode", "role", "epoch", "ready")}],
                   launches=dep.launches_of(f"controller{standby}",
                                            signal.SIGUSR1))
    return out


async def _funnel_traffic(dep, ports):
    import aiohttp
    from openwhisk_tpu_torch.controller.entitlement import \
        CONCURRENT_LIMIT_MESSAGE
    balancer_port, fronts = ports[0], ports[1:]
    conn = aiohttp.TCPConnector(limit=FUNNEL_BURST)
    out = {}
    async with aiohttp.ClientSession(
            connector=conn, auth=_basic(),
            timeout=aiohttp.ClientTimeout(total=60)) as s:
        await _fleet_up(s, balancer_port)
        base = f"http://127.0.0.1:{dep.api}/api/v1/namespaces/_"
        async with s.put(f"{base}/actions/echo?overwrite=true", json={
                "exec": {"kind": "python:3", "code": ECHO_CODE},
                "limits": {"memory": DEPLOY_ACTION_MB}}) as r:
            require(r.status == 200, f"funnel: PUT echo {r.status}")
        bad = []

        async def blocking(url, n):
            t = time.perf_counter()
            async with s.post(f"{url}/actions/echo?blocking=true&result=true",
                              json={"n": n}) as r:
                body = await r.json(content_type=None)
            return r.status, body, (time.perf_counter() - t) * 1e3

        st, body, first_ms = await blocking(base, -1)
        require(st == 200 and body == {"n": -1},
                f"funnel: the first invoke {st} {body}")
        dep.launches_of(f"controller{FUNNEL_INSTANCES[0]}", signal.SIGUSR2)
        sem = asyncio.Semaphore(DEPLOY_INFLIGHT)

        async def limited(url, n):
            async with sem:
                st, body, ms = await blocking(url, n)
                if st != 200 or body != {"n": n}:
                    bad.append((n, st, body))
                return ms

        # the same invokes straight to the balancer (it serves the API
        # too), then through the edge and the frontends
        direct = f"http://127.0.0.1:{balancer_port}/api/v1/namespaces/_"
        t0 = time.perf_counter()
        direct_ms = await asyncio.gather(*[
            limited(direct, 30_000 + n) for n in range(FUNNEL_BLOCKING)])
        direct_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ms = await asyncio.gather(*[limited(base, n) for n in
                                    range(FUNNEL_BLOCKING)])
        conc_s = time.perf_counter() - t0
        aids = {}

        async def fire(n):
            async with s.post(f"{base}/actions/echo", json={"n": n}) as r:
                body = await r.json(content_type=None)
                if r.status != 202 or "activationId" not in body:
                    bad.append((n, r.status, body))
                else:
                    aids[body["activationId"]] = n

        await asyncio.gather(*[fire(10_000 + n)
                               for n in range(FUNNEL_NONBLOCKING)])
        t0 = time.perf_counter()
        pending = dict(aids)
        while pending and time.perf_counter() - t0 < 60:
            for aid in list(pending):
                async with s.get(f"{base}/activations/{aid}") as r:
                    if r.status == 200:
                        rec = await r.json()
                        if rec.get("response", {}).get("result") != \
                                {"n": pending.pop(aid)}:
                            bad.append((aid, rec.get("response")))
            if pending:
                await asyncio.sleep(0.1)
        # a burst past one frontend's funnel depth: the overflow answers
        # the front door's exact 429 text
        front = f"http://127.0.0.1:{fronts[0]}/api/v1/namespaces/_"
        burst = await asyncio.gather(*[blocking(front, 20_000 + n)
                                       for n in range(FUNNEL_BURST)])
        launches = {f"controller{i}": dep.launches_of(f"controller{i}",
                                                      signal.SIGUSR1)
                    for i in FUNNEL_INSTANCES}
        counters = {}
        for i, p in zip(FUNNEL_INSTANCES, ports):
            async with s.get(f"http://127.0.0.1:{p}/metrics") as r:
                text = await r.text()
            counters[f"controller{i}"] = {
                ln.split()[0]: float(ln.split()[1])
                for ln in text.splitlines()
                if ln.startswith("openwhisk_funnel_") and len(ln.split()) == 2}
        wst, wf = await _json_get(
            s, f"http://127.0.0.1:{balancer_port}/admin/latency/waterfall")
    codes = [st for st, _b, _ms in burst]
    out.update(
        first_invoke_ms=first_ms, invokes=FUNNEL_BLOCKING,
        invokes_per_s=FUNNEL_BLOCKING / conc_s,
        http_ms_p50_p99=_percentiles(ms),
        direct_invokes_per_s=FUNNEL_BLOCKING / direct_s,
        direct_http_ms_p50_p99=_percentiles(direct_ms),
        counters=counters,
        balancer_waterfall={k: wf.get("budget", {}).get(k) for k in (
            "stage_medians_ms", "e2e_p50_ms", "e2e_p99_ms", "count")},
        nonblocking=len(aids),
        nonblocking_unrecorded=len(pending), bad=bad[:5], n_bad=len(bad),
        burst={"offered": FUNNEL_BURST, "ok": codes.count(200),
               "429": codes.count(429),
               "other": [c for c in codes if c not in (200, 429)][:5],
               "texts_exact": all(
                   b.get("error") == CONCURRENT_LIMIT_MESSAGE
                   for st, b, _ms in burst if st == 429),
               "echoes_exact": all(
                   b == {"n": 20_000 + n} for n, (st, b, _ms) in
                   enumerate(burst) if st == 200)},
        launches=launches)
    return out


def _compute_apps():
    """`nvidia-smi --query-compute-apps` as it reads (its pids are the
    host's, which a sandboxed process need not share), or None off the
    card."""
    if DEVICE != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()


def _libcuda_mapped(pid):
    """Whether the process has libcuda.so mapped."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "libcuda.so" in f.read()
    except OSError:
        return None


def ha_phase():
    """Phase 10b and 10c: the HA deployments and the funnel as processes."""
    import os
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="chip-smoke-ha-")
    dep = HaDeployment(work)
    ring, idents = _tenants()
    asyncio.run(_seed_tenants(dep.db, idents))
    env = dict(DEPLOY_LIMITS)
    t_phase = time.perf_counter()
    lines = {}
    try:
        dep.start_base()
        dep.wait_for(["broker"] + [f"invoker{i}" for i in range(HA_INVOKERS)])
        # 10b, active/active: three controllers on the card, each with its
        # own journal and snapshot under one root, behind the edge
        aa_env = dict(env, CONFIG_whisk_ha_activeActive="true",
                      CONFIG_whisk_ha_activeActive_partitions=str(HA_PARTS))
        ports = [_free_port() for _ in AA_INSTANCES]
        names = [dep.start_controller(i, p, [
            "--ha", "--cluster-size", str(len(AA_INSTANCES)),
            "--balancer-journal", os.path.join(work, "aa-wal"),
            "--balancer-snapshot", os.path.join(work, "aa.snap"),
            "--balancer-snapshot-interval", "1"]
            + (["--seed-guest"] if i == AA_INSTANCES[0] else []), aa_env)
            for i, p in zip(AA_INSTANCES, ports)]
        dep.api = _free_port()
        dep.start_edge("edge-aa", ports, env=aa_env)
        t0 = time.perf_counter()
        up = dep.wait_for(names + ["edge-aa"])
        aa = asyncio.run(_aa_traffic(dep, ports, idents, ring))
        aa.update(up_s=up, set_s=time.perf_counter() - t0,
                  rcs=dep.stop_set([n for n in names
                                    if n != f"controller{AA_KILLED}"]
                                   + ["edge-aa"]))
        lines["active_active"] = aa
        # 10b, active/standby: two controllers on one snapshot + journal
        as_env = dict(env, CONFIG_whisk_ha_failover_enabled="true")
        ports = [_free_port() for _ in AS_INSTANCES]
        names = [dep.start_controller(i, p, [
            "--ha", "--cluster-size", str(len(AS_INSTANCES)),
            "--balancer-journal", os.path.join(work, "as-wal"),
            "--balancer-snapshot", os.path.join(work, "as.snap"),
            "--balancer-snapshot-interval", "1"], as_env)
            for i, p in zip(AS_INSTANCES, ports)]
        dep.api = _free_port()
        dep.start_edge("edge-as", ports)
        t0 = time.perf_counter()
        up = dep.wait_for(names + ["edge-as"])
        st = asyncio.run(_as_traffic(dep, ports, idents))
        st.update(up_s=up, set_s=time.perf_counter() - t0,
                  rcs=dep.stop_set([f"controller{st['standby']}",
                                    "edge-as"]))
        lines["active_standby"] = st
        # 10c, the funnel: one balancer on the card, two frontends behind
        # the edge
        ports = [_free_port() for _ in FUNNEL_INSTANCES]
        bal = FUNNEL_INSTANCES[0]
        fnames = [dep.start_controller(bal, ports[0], [
            "--cluster-size", "1"], env, role="balancer")]
        fnames += [dep.start_controller(i, p, [
            "--funnel-to", str(bal), "--funnel-depth", str(FUNNEL_DEPTH)],
            env, role="frontend")
            for i, p in zip(FUNNEL_INSTANCES[1:], ports[1:])]
        dep.api = _free_port()
        dep.start_edge("edge-funnel", ports[1:])
        t0 = time.perf_counter()
        up = dep.wait_for(fnames + ["edge-funnel"])
        fn = asyncio.run(_funnel_traffic(dep, ports))
        fn.update(up_s=up, set_s=time.perf_counter() - t0,
                  cuda_initialized={n: fn["launches"][n]["cuda_initialized"]
                                    for n in fnames},
                  libcuda_mapped={n: _libcuda_mapped(dep.procs[n][0].pid)
                                  for n in fnames},
                  nvidia_smi_compute_apps=_compute_apps(),
                  frontend_logs=[
                      "role=frontend" in dep.log(n) for n in fnames[1:]],
                  rcs=dep.stop_set(fnames + ["edge-funnel"]))
        lines["funnel"] = fn
    except Exception:
        for name in dep.procs:
            print(f"--- {name} log:\n{dep.log(name)[-3000:]}",
                  file=sys.stderr)
        raise
    finally:
        rest = dep.stop_set(list(dep.procs))
        doubles = dep.doubles()
        shutil.rmtree(work, ignore_errors=True)
    aa, st, fn = lines["active_active"], lines["active_standby"], \
        lines["funnel"]
    executed, twice = doubles
    say("ha", executed=executed, executed_twice=twice,
        base_rcs={k: v for k, v in rest.items()
                  if k == "broker" or k.startswith("invoker")},
        phase_s=time.perf_counter() - t_phase,
        **{k: v for k, v in lines.items() if k != "funnel"})
    say("funnel", **fn)
    fl, ph, miss = aa["fleet"], aa["phases"], aa["missing_after_kill"]
    say("fleet", views=fl, missing_after_kill=miss,
        active_active=dict(phases=ph, client_downtime_s=aa["burst"][
            "downtime_s"]),
        active_standby=dict(phases=st["phases"], client_downtime_s=st[
            "burst"]["downtime_s"]))
    require(all(v == 200 for v in fl["status"].values())
            and all(n == len(AA_INSTANCES) for n in fl["members"].values())
            and all(m == [] for m in fl["missing"].values()),
            f"fleet: every view 200 with {len(AA_INSTANCES)} members, none "
            f"missing: {fl}")
    require(fl["slo_merged"] == sum(fl["slo_members"])
            == sum(fl["slo_members_after"]),
            f"fleet: the merged SLO count is the members' sum: {fl}")
    require(fl["finished_merged"] == sum(fl["finished_members"])
            == sum(fl["finished_members_after"]),
            f"fleet: the merged waterfall's finished is the members' sum: "
            f"{fl}")
    require(miss["status"] == 200 and miss["members_missing"] == [AA_KILLED],
            f"fleet: the dead controller is labeled missing: {miss}")
    require(ph["complete"] and ph["downtime_s"] is not None
            and ph["downtime_s"] <= aa["burst"]["downtime_s"],
            f"fleet: the failover's phases are complete and within the "
            f"client's downtime {aa['burst']['downtime_s']}: {ph}")
    require(executed > 0 and twice == 0,
            f"ha: zero double executions ({twice} of {executed})")
    require(all(aa["confirm"]) and all(st["confirm"]),
            "ha: every tenant served again after the kill")
    require(set(aa["after"]) == set(range(HA_PARTS)) and all(
        aa["after"][p] > ep for p, ep in aa["dead_parts"].items()),
        f"ha: the survivors own all {HA_PARTS} partitions, the dead "
        f"owner's at higher epochs: {aa['after']} {aa['dead_parts']}")
    require(aa["burst"]["downtime_s"] is not None
            and aa["burst"]["tenants_served_after_kill"] == HA_TENANTS,
            f"ha: every tenant served after the kill: {aa['burst']}")
    require(DEVICE != "cuda" or all(
        sum(v.values()) > 0 for v in aa["launches"].values()),
        f"ha: the survivors launched the kernels: {aa['launches']}")
    require(st["ready"][0] == 200 and st["ready"][1]["role"] == "active"
            and st["ready"][1]["epoch"] >= 2,
            f"ha: the standby promoted: {st['ready']}")
    require(st["burst"]["downtime_s"] is not None,
            f"ha: the promoted standby served: {st['burst']}")
    require(DEVICE != "cuda" or sum(st["launches"].values()) > 0,
            f"ha: the promoted standby launched the kernels: "
            f"{st['launches']}")
    require(all(rc == 0 for rc in list(aa["rcs"].values())
                + list(st["rcs"].values()) + list(fn["rcs"].values())),
            f"ha: every process stopped by SIGTERM exits 0: "
            f"{aa['rcs']} {st['rcs']} {fn['rcs']}")
    require(fn["n_bad"] == 0 and fn["nonblocking_unrecorded"] == 0,
            f"funnel: every invoke answered with its echo: {fn['bad']}")
    require(fn["burst"]["429"] > 0 and fn["burst"]["ok"] > 0
            and not fn["burst"]["other"] and fn["burst"]["texts_exact"]
            and fn["burst"]["echoes_exact"],
            f"funnel: the overflow answers the exact 429: {fn['burst']}")
    require(all(fn["frontend_logs"]), "funnel: the frontends ran as such")
    require(not any(fn["cuda_initialized"][n] for n in fnames[1:])
            and (DEVICE != "cuda" or fn["cuda_initialized"][fnames[0]]),
            f"funnel: CUDA initialized in the balancer only: "
            f"{fn['cuda_initialized']}")
    # the card's contexts while the funnel set runs: this script's and the
    # balancer's, none of a frontend
    require(DEVICE != "cuda" or len(fn["nvidia_smi_compute_apps"]) == 2,
            f"funnel: two CUDA contexts on the card (this script and the "
            f"balancer): {fn['nvidia_smi_compute_apps']}")
    bl = fn["launches"][fnames[0]]
    require(DEVICE != "cuda" or bl["scan"] + bl["repair"] > 0,
            f"funnel: the balancer launched the kernels: {bl}")
    return lines


# --------------------------------------------------------------- phase 9c
#: the buckets whose first step is held against a repeat, the steps a
#: bucket, and the cold standalone's geometry and window
BUCKETS, BUCKET_REPS = (8, 16, 32, 64, 128, 256), 4
COLD_MEMORY_MB, COLD_WAVE, COLD_WINDOW_S, COLD_TIMEOUT_S = 4_096, 64, 20.0, 180


async def _bucket_steps(TB):
    """Each batch bucket's first step against its repeats on phase 7's
    path: `TpuBalancer()` on the card over phase 7's fleet (10,000
    invokers by pings, N = 16,384, A = 4,096), BUCKET_REPS waves of
    exactly B rows of phase 7's mix a bucket, one step each (nothing is
    acked: no release rows), each step's dispatch-to-readback ms."""
    from openwhisk_tpu_torch.core import entity as E
    ctrl = E.ControllerInstanceId("40")
    fleet = Fleet(seed=11)
    fleet.start()
    bal = TB.TpuBalancer(
        fleet.provider, ctrl, managed_fraction=0.9, blackbox_fraction=0.1,
        max_batch=MAX_BATCH, action_slots=A, initial_pad=64,
        device=None if DEVICE == "cuda" else DEVICE)
    bal._await_kernels()  # the early build is no step of a bucket's
    await bal.start()
    out = {}
    try:
        await fleet.ping(bal.supervision, list(range(N_INV)))
        bal._arm_flush()
        await _drain_front(bal)
        mix = ActionMix(seed=5, ctrl=ctrl)
        for b in BUCKETS:
            ms, buckets = [], []
            for _ in range(BUCKET_REPS):
                n0, s0 = len(bal.step_ms), bal.counters["steps"]
                futs = bal.publish_many(mix.pairs(b))
                await asyncio.gather(*futs)
                while bal._readbacks or bal._inflight_steps:
                    await asyncio.sleep(0.001)
                require(bal.counters["steps"] == s0 + 1,
                        f"buckets: {b} rows took one step")
                ms.append(bal.step_ms[n0])
            rep_ms = float(np.median(ms[1:]))
            out[str(b)] = dict(first_ms=ms[0], repeat_ms=rep_ms,
                               first_minus_repeat_ms=ms[0] - rep_ms,
                               ms=ms)
    finally:
        await bal.close()
        await fleet.stop()
    return out


def cold_standalone(root, counts_path, port):
    """`--cold-standalone ROOT COUNTS PORT`: the standalone of the package
    copied under ROOT (its build directory empty), unthrottled, on the
    card; the kernel wrappers' launch counts go to COUNTS on SIGUSR1, as
    phase 9's controller writes them."""
    import os
    sys.path.insert(0, root)
    from openwhisk_tpu_torch import standalone as S
    from openwhisk_tpu_torch.ops import _build
    from openwhisk_tpu_torch.ops import placement_cuda as K
    from openwhisk_tpu_torch.utils.tasks import wait_for_shutdown
    require(S.__file__.startswith(root) and not any(
        _build.BUILD_DIR.glob("*.so")),
        f"cold: the copy's package with an empty build directory: "
        f"{S.__file__} {_build.BUILD_DIR}")

    def dump(*_):
        tmp = f"{counts_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"scan": K.schedule_batch_cuda.launches,
                       "repair": K.schedule_batch_repair_cuda.launches}, f)
        os.replace(tmp, counts_path)

    signal.signal(signal.SIGUSR1, dump)

    async def run():
        ctrl = await S.make_standalone(
            port=port, balancer="tpu", ui=False,
            user_memory_mb=COLD_MEMORY_MB, **UNTHROTTLED,
            **_standalone_kw())
        print(f"cold standalone up on :{port}", flush=True)
        try:
            await wait_for_shutdown()
        finally:
            await ctrl.stop()

    asyncio.run(run())
    return 0


async def _cold_traffic(port, counts, proc, t_start):
    """Drive one cold standalone: /admin/ready, the echo action, one
    blocking invoke, then waves of COLD_WAVE blocking invokes at once
    until both kernels were launched (at most three), the host profile
    at COLD_WINDOW_S from the process's start, the kernel profile."""
    import aiohttp
    import os
    from openwhisk_tpu_torch import standalone as S
    out, bad = {}, []
    base = f"http://127.0.0.1:{port}"
    async with aiohttp.ClientSession(
            auth=aiohttp.BasicAuth(S.GUEST_UUID, S.GUEST_KEY),
            timeout=aiohttp.ClientTimeout(total=120)) as s:
        while True:
            require(proc.poll() is None, "cold: the standalone exited")
            require(time.perf_counter() - t_start < COLD_TIMEOUT_S,
                    "cold: /admin/ready within the limit")
            st, _ = await _json_get(s, f"{base}/admin/ready",
                                    auth=aiohttp.BasicAuth(S.GUEST_UUID,
                                                           S.GUEST_KEY))
            if st == 200:
                break
            await asyncio.sleep(0.05)
        out["ready_s"] = time.perf_counter() - t_start
        while True:  # the in-process invoker's first ping
            st, inv = await _json_get(s, f"{base}/invokers")
            if st == 200 and "up" in inv.values():
                break
            require(time.perf_counter() - t_start < COLD_TIMEOUT_S,
                    f"cold: the invoker is up: {inv}")
            await asyncio.sleep(0.05)
        out["invoker_up_s"] = time.perf_counter() - t_start
        _st, prof = await _json_get(s, f"{base}/admin/profile/kernel")
        out["nvcc_done_at_invoker_up"] = sorted(
            b["source"] for b in prof.get("kernel_builds", [])
            if b["how"] == "nvcc")
        api = f"{base}/api/v1/namespaces/_"
        async with s.put(f"{api}/actions/echo?overwrite=true", json={
                "exec": {"kind": "python:3", "code": ECHO_CODE},
                "limits": {"memory": DEPLOY_ACTION_MB}}) as r:
            require(r.status == 200, f"cold: PUT echo {r.status}")

        async def invoke(n):
            t = time.perf_counter()
            async with s.post(f"{api}/actions/echo?blocking=true&result=true",
                              json={"n": n}) as r:
                body = await r.json(content_type=None)
            if r.status != 200 or body != {"n": n}:
                bad.append((n, r.status, body))
            return (time.perf_counter() - t) * 1e3

        out["first_invoke_ms"] = await invoke(-1)
        out["first_invoke_done_s"] = time.perf_counter() - t_start
        # the loop's lag from the observatory's install to here: the
        # window in which nvcc ran (the first invoke waits for the build)
        _st, host = await _json_get(
            s, f"{base}/admin/profile/host?collapsed=1")
        lag = host.get("loop_lag", {})
        # the sampler's heaviest loop-thread stacks so far (their last
        # frames): where a stall sat
        stacks = [ln.rsplit(" ", 1) for ln in
                  str(host.get("collapsed", "")).splitlines() if " " in ln]
        out["stacks_top"] = [[";".join(st.split(";")[-8:]), int(n)]
                             for st, n in stacks[:5]]
        out["loop_lag_through_first_invoke_ms"] = {
            k: lag.get(k) for k in ("max_ms", "p99_ms", "ticks")}
        # where the loop stalled: the observatory's worst coroutine
        # resumptions through the first invoke
        out["stalls_worst"] = host.get("stalls", {}).get("worst", [])[:4]
        launches, waves = {}, 0
        while waves < 3:
            waves += 1
            await asyncio.gather(*[invoke(waves * 1000 + n)
                                   for n in range(COLD_WAVE)])
            stamp = os.path.getmtime(counts) if os.path.exists(counts) \
                else None
            proc.send_signal(signal.SIGUSR1)
            for _ in range(500):
                if os.path.exists(counts) and \
                        os.path.getmtime(counts) != stamp:
                    time.sleep(0.02)
                    with open(counts) as f:
                        launches = json.load(f)
                    break
                await asyncio.sleep(0.01)
            if launches.get("scan") and launches.get("repair"):
                break
        out.update(waves=waves, invokes=1 + waves * COLD_WAVE,
                   launches=launches, bad=bad[:5], n_bad=len(bad))
        wait = t_start + COLD_WINDOW_S - time.perf_counter()
        if wait > 0:
            await asyncio.sleep(wait)
        out["host_window_s"] = time.perf_counter() - t_start
        _st, host = await _json_get(s, f"{base}/admin/profile/host")
        lag = host.get("loop_lag", {})
        out["loop_lag_ms"] = {k: lag.get(k) for k in ("max_ms", "p99_ms",
                                                      "ticks")}
        _st, prof = await _json_get(s, f"{base}/admin/profile/kernel")
        out["kernel_builds"] = prof.get("kernel_builds", [])
    return out


def cold_phase(TB):
    """9c: a checkout with no build directory. The bucket ladder's
    measurement first (in this process), then the package copied (not the
    build directory) into a temporary root and its standalone started
    from there twice: the early build on, then
    `CONFIG_whisk_loadBalancer_prewarm=false`."""
    import os
    import shutil
    import tempfile
    buckets = asyncio.run(_bucket_steps(TB))
    say("buckets", buckets=buckets)
    runs = {}
    for label, env in (("prewarm_on", {}),
                       ("prewarm_off",
                        {"CONFIG_whisk_loadBalancer_prewarm": "false"})):
        root = tempfile.mkdtemp(prefix="chip-smoke-cold-")
        try:
            shutil.copytree(
                os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "openwhisk_tpu_torch"),
                os.path.join(root, "openwhisk_tpu_torch"),
                ignore=shutil.ignore_patterns("__pycache__"))
            port, counts = _free_port(), os.path.join(root, "launches.json")
            log_path = os.path.join(root, "standalone.log")
            t_start = time.perf_counter()
            with open(log_path, "w") as log:
                proc = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--cold-standalone", root, counts, str(port)],
                    stdout=log, stderr=subprocess.STDOUT, cwd=root,
                    env=dict(os.environ, PYTHONUNBUFFERED="1", **env))
                try:
                    run = asyncio.run(_cold_traffic(port, counts, proc,
                                                    t_start))
                except Exception:
                    with open(log_path) as f:
                        print(f"--- cold {label} log:\n{f.read()[-3000:]}",
                              file=sys.stderr)
                    raise
                finally:
                    if proc.poll() is None:
                        proc.send_signal(signal.SIGTERM)
                    try:
                        run_rc = proc.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        run_rc = proc.wait()
        finally:
            shutil.rmtree(root, ignore_errors=True)
        nvcc = {b["source"]: b["seconds"] for b in run["kernel_builds"]
                if b["how"] == "nvcc"}
        run.update(rc=run_rc, nvcc_s=nvcc,
                   nvcc_s_max=max(nvcc.values(), default=None))
        runs[label] = run
    say("cold", **runs)
    for label, run in runs.items():
        require(run["rc"] == 0 and run["n_bad"] == 0,
                f"cold {label}: every invoke answered 200 with its echo, "
                f"exit 0: {run['rc']} {run['bad']}")
        require(run["launches"].get("scan", 0) > 0
                and run["launches"].get("repair", 0) > 0,
                f"cold {label}: both kernels launched: {run['launches']}")
        require(set(run["nvcc_s"]) == set(TB.placement_cuda.SOURCES),
                f"cold {label}: every kernel built by nvcc in the "
                f"standalone: {run['kernel_builds']}")
    on, off = runs["prewarm_on"], runs["prewarm_off"]
    lag_on = on["loop_lag_through_first_invoke_ms"]
    require(lag_on["max_ms"] < 250.0,
            f"cold: with prewarm on the loop lag stays under 0.25 s while "
            f"nvcc runs: {lag_on} (nvcc {on['nvcc_s']})")
    require(off["first_invoke_ms"] >= 1e3 * off["nvcc_s"]["placement_scan"],
            f"cold: with prewarm off the first invoke waits for nvcc: "
            f"{off['first_invoke_ms']} ms, nvcc {off['nvcc_s']}")
    return dict(buckets=buckets, **runs)


# --------------------------------------------------------------- phase 12
#: the store's size (the BASELINE's 2,000 actions at 128 MB), the blocking
#: invokes and their concurrency, the burst at one controller, the PUTs'
#: concurrency and the docstore reads timed from this process
TOOLS_ACTIONS, TOOLS_BLOCKING, TOOLS_INFLIGHT, TOOLS_BURST = 2_000, 300, 16, 64
TOOLS_PUT_INFLIGHT, TOOLS_READS = 32, 1_000
TOOLS_SUBJECT = "tools-tenant"
#: each service's up line, by name prefix
TOOLS_MARKS = {"bus": "listening on", "docstore": "docstore up on",
               "invoker": ") up", "controller": " up on :",
               "monitoring": "user-events metrics on",
               "edge": "edge proxy on"}


def _two_free_ports():
    """A free port whose successor is free too (the controllers'
    `base_port`: controller i listens on base + i)."""
    import socket
    for _ in range(100):
        base = _free_port()
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", base + 1))
            return base
        except OSError:
            continue
    raise RuntimeError("tools: no two consecutive free ports")


def _sandbox_states():
    """The container pools as the OS shows them: every action proxy
    process (a python:3 sandbox) with its parent (the invoker), its
    state and its port; `T` is stopped, i.e. paused."""
    import os
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            at = [i for i, a in enumerate(argv) if b"actionproxy" in a]
            if not at:
                continue
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except OSError:
            continue
        # the proxy's argument after its path is its port
        out.append({"pid": int(pid), "ppid": int(ppid), "state": state,
                    "port": argv[at[0] + 1].decode()})
    return out


def _report_502(bad, logs, pending=()):
    """Beside any 502 among `bad` ((id, status, body) rows) or any
    activation never recorded (`pending` ids), before the phase fails:
    each invoker's log tail and the sandboxes' states."""
    if not pending and not any(len(b) > 2 and b[1] == 502 for b in bad):
        return
    if pending:
        print(f"--- never recorded: {sorted(pending)}", file=sys.stderr)
    for name, text in logs.items():
        if name.startswith("invoker"):
            print(f"--- {name} log tail:\n{text[-3000:]}", file=sys.stderr)
    print(f"--- sandboxes: {json.dumps(_sandbox_states())}", file=sys.stderr)


class ToolsDeployment:
    """Phase 12's deployment: the services the port's
    `deploy.services(inv)` lists for a JSON inventory of
    `deploy/cluster.yaml`'s keys, started as the tool's `up` starts them
    (its argv, its environment, its order, its pid files in the rundir),
    each controller's argv after `-m openwhisk_tpu_torch.controller` run
    under `--deploy-controller` so that its launch counts can be read."""

    def __init__(self, work):
        import os
        from openwhisk_tpu_torch.tools import deploy as D
        self.D, self.work = D, work
        self.db = os.path.join(work, "whisks.db")
        inv = {"rundir": os.path.join(work, "run"), "db": self.db,
               "bus": {"port": _free_port()},
               "docstore": {"enabled": True, "port": _free_port()},
               "controllers": {"count": 2, "base_port": _two_free_ports(),
                               "balancer": "tpu", "seed_guest": True},
               "invokers": {"count": DEPLOY_INVOKERS,
                            "memory_mb": DEPLOY_MEMORY_MB},
               "edge": {"enabled": True, "port": _free_port()},
               "monitoring": {"enabled": True, "port": _free_port()},
               "limits": {k.rsplit("_", 1)[1]: v
                          for k, v in DEPLOY_LIMITS.items()}}
        if DEVICE != "cuda":
            inv["controllers"]["device"] = DEVICE
        self.inventory = os.path.join(work, "inventory.json")
        with open(self.inventory, "w") as f:
            json.dump(inv, f)
        self.inv = D.load_inventory(self.inventory)
        ctrl = self.inv["controllers"]
        self.controllers = [f"http://127.0.0.1:{ctrl['base_port'] + i}"
                            for i in range(ctrl["count"])]
        self.edge = f"http://127.0.0.1:{self.inv['edge']['port']}"
        self.docstore = f"docstore://127.0.0.1:{self.inv['docstore']['port']}"
        self.procs, self.started = {}, {}

    def path(self, name, suffix):
        import os
        return os.path.join(self.inv["rundir"], f"{name}.{suffix}")

    def start(self):
        import os
        os.makedirs(self.inv["rundir"])
        env = self.D._env(self.inv)
        env.setdefault("PYTHONPATH", os.getcwd())
        for svc in self.D.services(self.inv):
            name, argv = svc["name"], list(svc["argv"])
            if name.startswith("controller"):
                i = argv.index("openwhisk_tpu_torch.controller")
                argv = [argv[0], os.path.abspath(__file__),
                        "--deploy-controller", self.path(name, "json"),
                        *argv[i + 1:]]
            log = open(self.path(name, "log"), "ab")
            self.started[name] = time.perf_counter()
            proc = subprocess.Popen(argv, stdout=log, stderr=log, env=env,
                                    start_new_session=True)
            with open(self.path(name, "pid"), "w") as f:
                f.write(str(proc.pid))
            self.procs[name] = (proc, log)
            if name in ("bus", "docstore"):
                self.wait_up([name])  # `up` sleeps a second here instead

    def log(self, name):
        with open(self.path(name, "log"), errors="replace") as f:
            return f.read()

    def wait_up(self, names=None, timeout=DEPLOY_TIMEOUT_S):
        """Seconds from each service's start to its up line."""
        names = list(names or self.procs)
        up = {}
        t0 = time.perf_counter()
        while len(up) < len(names):
            for name in names:
                mark = next(v for k, v in TOOLS_MARKS.items()
                            if name.startswith(k))
                if name not in up and mark in self.log(name):
                    up[name] = time.perf_counter() - self.started[name]
                proc = self.procs[name][0]
                require(proc.poll() is None,
                        f"tools: {name} exited {proc.returncode}: "
                        f"{self.log(name)[-2000:]}")
            require(time.perf_counter() - t0 < timeout,
                    f"tools: {sorted(set(names) - set(up))} not up")
            time.sleep(0.05)
        return up

    def tool(self, module, *args):
        """`python -m openwhisk_tpu_torch.tools.MODULE ARGS` as a process:
        (exit code, stdout, wall ms)."""
        import os
        t = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", f"openwhisk_tpu_torch.tools.{module}",
             *args], capture_output=True, text=True, timeout=120,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        ms = (time.perf_counter() - t) * 1e3
        require(out.returncode in (0, 1),
                f"tools: {module} {args} exited {out.returncode}: "
                f"{out.stderr[-2000:]}")
        return out.returncode, out.stdout, ms

    def launches(self, sig):
        """Each controller's launch counts (SIGUSR1 reads, SIGUSR2 resets
        to 0), as phase 9 reads its controller's."""
        return {name: _signal_counts(self.procs[name][0],
                                     self.path(name, "json"), sig,
                                     f"tools: {name}")
                for name in sorted(n for n in self.procs
                                   if n.startswith("controller"))}

    def down(self):
        """The tool's `down` as a process; every pid gone within 30 s.
        Returns (its exit code, ms, each service's exit code)."""
        rc, _out, ms = self.tool("deploy", "-i", self.inventory, "down")
        rcs = {}
        t0 = time.perf_counter()
        for name, (proc, log) in self.procs.items():
            try:
                rcs[name] = proc.wait(
                    timeout=max(0.1, 30 - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                rcs[name] = None
                proc.kill()
                proc.wait()
            log.close()
        return rc, ms, rcs


def _tools_cli(dep):
    """Traffic 1 and 2: `wskadmin user create` over the docstore, then the
    `wsk` commands through the edge as processes, each timed and its
    printed JSON kept."""
    import os
    ms, outs = {}, {}
    rc, key, ms["wskadmin user create"] = dep.tool(
        "wskadmin", "--db", dep.docstore, "user", "create", TOOLS_SUBJECT)
    key = key.strip()
    require(rc == 0 and key.count(":") == 1,
            f"tools: wskadmin user create printed a key: {rc} {key!r}")
    for name, code in (("echo", ECHO_CODE), ("step", STEP_CODE)):
        with open(os.path.join(dep.work, f"{name}.py"), "w") as f:
            f.write(code)
    commands = [
        ("action create echo", ["action", "create", "echo",
                                os.path.join(dep.work, "echo.py")]),
        ("action create step", ["action", "create", "step",
                                os.path.join(dep.work, "step.py")]),
        ("action create --sequence", ["action", "create", "twice",
                                      "--sequence", "step,step"]),
        ("package create", ["package", "create", "utils", "-p", "who",
                            "provider"]),
        ("package bind", ["package", "bind", "utils", "bound", "-p", "who",
                          "binding"]),
        ("action invoke --blocking --result", [
            "action", "invoke", "twice", "-p", "n", "5", "--blocking",
            "--result"]),
        ("action invoke echo", ["action", "invoke", "echo", "-p", "n", "1",
                                "--blocking"]),
        ("activation list", ["activation", "list"])]
    wsk = ["--apihost", dep.edge, "--auth", key]
    for label, argv in commands:
        rc, out, ms[label] = dep.tool("wsk", *wsk, *argv)
        require(rc == 0, f"tools: wsk {label} exited {rc}: {out[-500:]}")
        outs[label] = json.loads(out)
    aid = outs["action invoke echo"]["activationId"]
    rc, out, ms["activation get"] = dep.tool("wsk", *wsk, "activation", "get",
                                             aid)
    require(rc == 0, f"tools: wsk activation get exited {rc}")
    outs["activation get"] = json.loads(out)
    return key, ms, outs


async def _tools_rest_checks(s, dep, outs):
    """`wsk`'s printed JSON against the REST bodies of the same entities
    (through the edge)."""
    base = f"{dep.edge}/api/v1/namespaces/_"
    rest = {}
    for label, path in (("action create echo", "actions/echo"),
                        ("action create --sequence", "actions/twice"),
                        ("package bind", "packages/bound"),
                        ("activation get", "activations/"
                         + outs["activation get"]["activationId"])):
        async with s.get(f"{base}/{path}") as r:
            require(r.status == 200, f"tools: GET {path} {r.status}")
            rest[label] = await r.json()
    for label, body in rest.items():
        # a package's GET adds its contents (`actions`); `updated` is the
        # store's write clock
        require({k: body.get(k) for k in outs[label] if k != "updated"}
                == {k: v for k, v in outs[label].items() if k != "updated"},
                f"tools: wsk {label} printed the REST body: {outs[label]} "
                f"!= {body}")
    require(outs["action invoke --blocking --result"] == {"n": 7},
            f"tools: the sequence's result: "
            f"{outs['action invoke --blocking --result']}")
    require(outs["action invoke echo"]["response"]["result"] == {"n": 1},
            "tools: wsk's echo invoke")
    listed = {a["activationId"] for a in outs["activation list"]}
    require(outs["activation get"]["activationId"] in listed,
            f"tools: activation list names the echo invoke: {listed}")
    require(outs["package bind"]["binding"]["name"] == "utils",
            f"tools: the binding names its provider: {outs['package bind']}")


async def _tools_traffic(dep, key, outs):
    """Traffic 3-5 over HTTP (aiohttp): the 2,000 actions through the edge,
    the blocking invokes through the edge, the burst at controller 0 read
    back through controller 1."""
    import aiohttp
    u, _, k = key.partition(":")
    base = f"{dep.edge}/api/v1/namespaces/_"
    out, bad = {}, []
    conn = aiohttp.TCPConnector(limit=TOOLS_BURST)
    async with aiohttp.ClientSession(connector=conn,
                                     auth=aiohttp.BasicAuth(u, k)) as s:
        await _tools_rest_checks(s, dep, outs)
        sem = asyncio.Semaphore(TOOLS_PUT_INFLIGHT)

        async def put(i):
            async with sem, s.put(f"{base}/actions/a{i}", json={
                    "exec": {"kind": "python:3", "code": ECHO_CODE},
                    "limits": {"memory": DEPLOY_ACTION_MB}}) as r:
                return r.status

        t0 = time.perf_counter()
        puts = await asyncio.gather(*[put(i) for i in range(TOOLS_ACTIONS)])
        out["create_s"] = time.perf_counter() - t0
        require(puts == [200] * TOOLS_ACTIONS,
                f"tools: every action created: "
                f"{sorted(set(puts) - {200})}")
        rng = np.random.RandomState(12)
        picks = rng.choice(TOOLS_ACTIONS, TOOLS_BLOCKING,
                           p=_zipf(TOOLS_ACTIONS))
        inflight = asyncio.Semaphore(TOOLS_INFLIGHT)
        aids, cold = [], []

        async def blocking(n, a):
            async with inflight:
                t = time.perf_counter()
                async with s.post(f"{base}/actions/a{a}?blocking=true",
                                  json={"n": n}) as r:
                    body = await r.json(content_type=None)
                    ms = (time.perf_counter() - t) * 1e3
                    if r.status != 200 or body.get("response", {}).get(
                            "result") != {"n": n}:
                        bad.append((n, r.status, body))
                    else:
                        aids.append(body["activationId"])
                        cold.append(any(x.get("key") == "initTime"
                                        for x in body.get("annotations", [])))
                    return ms

        t0 = time.perf_counter()
        http_ms = await asyncio.gather(*[blocking(n, int(a))
                                         for n, a in enumerate(picks)])
        wall = time.perf_counter() - t0
        out.update(invokes=TOOLS_BLOCKING,
                   distinct_actions=len(set(picks.tolist())),
                   invokes_per_s=TOOLS_BLOCKING / wall,
                   http_ms_p50_p99=_percentiles(http_ms),
                   cold=int(sum(cold)), warm=len(cold) - int(sum(cold)),
                   http_ms_p50_p99_cold=_percentiles(
                       [m for m, c in zip(http_ms, cold) if c]),
                   http_ms_p50_p99_warm=_percentiles(
                       [m for m, c in zip(http_ms, cold) if not c]))
        # the burst at controller 0: one admission wave a step of 32 rows
        # or more (the repair); up to three waves until a repair launched
        c0 = f"{dep.controllers[0]}/api/v1/namespaces/_"
        burst = {}

        async def fire(n):
            async with s.post(f"{c0}/actions/echo", json={"n": n}) as r:
                body = await r.json(content_type=None)
                if r.status != 202 or "activationId" not in body:
                    bad.append((n, r.status, body))
                else:
                    burst[body["activationId"]] = n

        waves = []
        for w in range(3):
            await asyncio.gather(*[fire(100_000 + w * TOOLS_BURST + n)
                                   for n in range(TOOLS_BURST)])
            waves.append(dep.launches(signal.SIGUSR1))
            if sum(v["repair"] for v in waves[-1].values()) > 0 or \
                    DEVICE != "cuda":
                break
        # every acknowledged activation, once complete, read back through
        # the other controller (both share the docstore)
        c1 = f"{dep.controllers[1]}/api/v1/namespaces/_"
        pending, t_poll = dict(burst), time.perf_counter()
        while pending and time.perf_counter() - t_poll < DEPLOY_TIMEOUT_S:
            for aid in list(pending):
                async with s.get(f"{c1}/activations/{aid}") as r:
                    if r.status == 200:
                        rec = await r.json()
                        n = pending.pop(aid)
                        if rec.get("response", {}).get("result") != {"n": n}:
                            bad.append((aid, r.status, rec))
            if pending:
                await asyncio.sleep(0.1)
        out["burst"] = dict(invokes=len(burst), waves=len(waves),
                            read_back_s=time.perf_counter() - t_poll)
        if bad:
            _report_502(bad, {n: dep.log(n) for n in dep.procs})
        require(not bad, f"tools: every invoke answered with its echo: "
                         f"{bad[:5]}")
        require(not pending, f"tools: {len(pending)} burst activations "
                             "never read back through controller 1")
    out["activation_ids"] = aids + list(burst) + [
        outs["action invoke echo"]["activationId"]]
    return out


async def _docstore_reads(dep, n):
    """TOOLS_READS gets of action docs from a `RemoteArtifactStore` in this
    process: p50/p99 ms."""
    from openwhisk_tpu_torch.database import RemoteArtifactStore
    port = dep.inv["docstore"]["port"]
    store = RemoteArtifactStore("127.0.0.1", port)
    ms = []
    try:
        for i in range(n):
            t = time.perf_counter()
            doc = await store.get(f"{TOOLS_SUBJECT}/a{i % TOOLS_ACTIONS}")
            ms.append((time.perf_counter() - t) * 1e3)
            require(doc["name"] == f"a{i % TOOLS_ACTIONS}",
                    "tools: the docstore read its action")
    finally:
        await store.close()
    return _percentiles(ms)


async def _stored(db, aids):
    """After `down`: the docstore's sqlite file through the port's
    `open_store(path)`: the actions in the tenant's namespace and the
    acknowledged activations it holds."""
    from openwhisk_tpu_torch.database import NoDocumentException, open_store
    store = open_store(db)
    try:
        actions = await store.count("actions", TOOLS_SUBJECT)
        held = 0
        for aid in aids:
            try:
                await store.get(f"{TOOLS_SUBJECT}/{aid}")
                held += 1
            except NoDocumentException:
                pass
    finally:
        await store.close()
    return actions, held


def tools_phase():
    """Phase 12: the reference's documented deployment shape through the
    port's `owdeploy`, `wskadmin` and `wsk` (module docstring)."""
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="chip-smoke-tools-")
    dep = ToolsDeployment(work)
    t_phase = time.perf_counter()
    try:
        dep.start()
        try:
            up_s = dep.wait_up()
            rc, status, status_ms = dep.tool("deploy", "-i", dep.inventory,
                                              "status")
            boots = {n: next((ln for ln in dep.log(n).splitlines()
                              if " up on :" in ln), "")
                     for n in dep.procs if n.startswith("controller")}
            asyncio.run(_fleet_seen(dep))
            before = dep.launches(signal.SIGUSR2)  # 0 before the path
            key, cli_ms, outs = _tools_cli(dep)
            traffic = asyncio.run(_tools_traffic(dep, key, outs))
            launches = dep.launches(signal.SIGUSR1)
            reads = asyncio.run(_docstore_reads(dep, TOOLS_READS))
        except Exception:
            for name in dep.procs:
                print(f"--- {name} log:\n{dep.log(name)[-3000:]}",
                      file=sys.stderr)
            raise
        finally:
            down_rc, down_ms, rcs = dep.down()
        actions, held = asyncio.run(_stored(dep.db,
                                            traffic["activation_ids"]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    aids = traffic.pop("activation_ids")
    line = dict(
        services=len(dep.procs), invokers=DEPLOY_INVOKERS,
        controllers=len(dep.controllers), up_s=up_s,
        status=dict(rc=rc, ms=status_ms), cli_ms=cli_ms,
        down=dict(rc=down_rc, ms=down_ms, exit_codes=rcs),
        store=dict(actions=actions, activations_acknowledged=len(aids),
                   activations_held=held,
                   get_ms_p50_p99_remote=reads),
        launches=launches, launches_before=before,
        boot_lines=boots, **traffic,
        phase_s=time.perf_counter() - t_phase)
    say("tools", **line)
    require(rc == 0 and all(f"{n}: up" in status for n in dep.procs),
            f"tools: owdeploy status shows every service up: {status}")
    require(all(rc is not None for rc in rcs.values()),
            f"tools: every pid gone within 30 s of owdeploy down: {rcs}")
    device = "cuda" if DEVICE == "cuda" else DEVICE
    require(all(f"device={device}" in ln for ln in boots.values()),
            f"tools: both controllers place on {device}: {boots}")
    require(all(v["scan"] == 0 and v["repair"] == 0
                for v in before.values()),
            "tools: the controllers' counts were reset before the traffic")
    require(DEVICE != "cuda" or (
        all(v["scan"] > 0 for v in launches.values())
        and sum(v["repair"] for v in launches.values()) > 0),
        f"tools: each controller launched the scan, the two the repair: "
        f"{launches}")
    require(actions >= TOOLS_ACTIONS and held == len(aids),
            f"tools: after down the docstore's file holds the "
            f"{TOOLS_ACTIONS} actions ({actions}) and every acknowledged "
            f"activation ({held} of {len(aids)})")
    return line


async def _fleet_seen(dep):
    """Every controller shows the DEPLOY_INVOKERS invokers up."""
    import aiohttp
    async with aiohttp.ClientSession() as s:
        for url in dep.controllers:
            t0 = time.perf_counter()
            while True:
                st, body = await _json_get(s, f"{url}/invokers")
                if st == 200 and sum(v == "up" for v in body.values()) \
                        == DEPLOY_INVOKERS:
                    break
                require(time.perf_counter() - t0 < DEPLOY_TIMEOUT_S,
                        f"tools: the fleet is up at {url}: {body}")
                await asyncio.sleep(0.2)



# --------------------------------------------------------------- phase 13
#: 13a: the open-loop sweep over the BASELINE fleet, and the fleet it is
#: rerun at when the echo fleet fails the first (module docstring)
LOADGEN_INVOKERS = (10_000, 1_024)
#: six doublings: rungs 64 to 2,048/s (the copy's default of eight found
#: 4,096/s unsustained at 1,024 invokers on an H100, p99 1.7-2.3 s, at
#: 15-20 s a run)
LOADGEN_RATE0, LOADGEN_DURATION, LOADGEN_DOUBLINGS = 64.0, 2.5, 6
#: 13c: worker processes of the shared topology
LOADGEN_PROCS = 2
#: 13d: (simulation, requests, concurrency), as their CLIs take them
SIMULATIONS = (("latency", 100, 1), ("throughput", 300, 4),
               ("cold", 20, 4), ("apiv1", 100, 4))
OWPERF_SAMPLES, OWPERF_RATIO = 20, 2
#: the sweep's rows at 64 requests a batch (the reference's default is
#: 256): the 8-shard scan is a loop of requests, 2.3-5.4 s a 256-row step
SWEEP_SIZES, SWEEP_BATCH, SWEEP_ITERS = (16, 256, 4096, 65536), 64, 2
WARMHIT_ARGS = dict(n_invokers=64, rounds=20, batch=128)


def _device_arg():
    """The port's device argument for DEVICE: None (the card) or "cpu"."""
    return None if DEVICE == "cuda" else DEVICE


def _instances(cls):
    """Every instance of `cls` this process builds from now on."""
    made = []
    init = cls.__init__

    def track(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    cls.__init__ = track
    return made


def _count_steps(TB, counts):
    """Count every `TpuBalancer` step of this process into `counts`
    ("steps", and "rows" they placed; "in_step" is True during one);
    returns the undo."""
    dispatch = TB.TpuBalancer._dispatch_batch

    def step(self):
        counts["steps"] += 1
        counts["rows"] += min(len(self._pending), self.max_batch)
        counts["in_step"] = True
        try:
            return dispatch(self)
        finally:
            counts["in_step"] = False

    TB.TpuBalancer._dispatch_batch = step
    return lambda: setattr(TB.TpuBalancer, "_dispatch_batch", dispatch)


def _count_loop_syncs(counts):
    """Count the host synchronisations this process's main thread (its
    event loop) makes, torch's sync debug mode on "warn": inside a step
    into counts["step_syncs"] (with `_count_steps`), elsewhere into
    counts["loop_syncs"]. On the CPU there is nothing to count."""
    import threading
    import warnings
    if not torch.cuda.is_available():
        return
    loop = threading.main_thread()
    show = warnings.showwarning

    def seen(message, *a, **k):
        if "ynchroniz" not in str(message):
            return show(message, *a, **k)
        if threading.current_thread() is loop:
            counts["step_syncs" if counts.get("in_step")
                   else "loop_syncs"] += 1

    warnings.showwarning = seen
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")


def loadgen_process(counts_dir, argv):
    """`--loadgen-process DIR ARGS...`: the load generator CLI's `main()`
    with ARGS, exactly as `python -m openwhisk_tpu_torch.tools.loadgen
    ARGS` runs it, then this process's kernel launch counts, whether it
    started a CUDA context and whether it mapped libcuda, written to
    DIR/<pid>.json as it exits. The funnel process also writes its hop
    (frames and rows received, outcome frames, steps, the rows they
    placed, host syncs on its loop), each front end its retries and rows
    timed out (13c reads them there)."""
    import os
    from openwhisk_tpu_torch.controller.loadbalancer import funnel as F
    from openwhisk_tpu_torch.controller.loadbalancer import tpu_balancer as TB
    from openwhisk_tpu_torch.tools import loadgen
    sys.argv = ["openwhisk_tpu_torch.tools.loadgen", *argv]
    serve = "--serve-funnel" in argv
    hop = {"steps": 0, "rows": 0, "step_syncs": 0, "loop_syncs": 0}
    if serve:
        receivers = _instances(F.FunnelReceiver)
        _count_steps(TB, hop)
        _count_loop_syncs(hop)
    else:
        front_ends = _instances(F.FunnelBalancer)
    try:
        return loadgen.main() or 0
    finally:
        if serve and torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode(0)
        K = sys.modules.get("openwhisk_tpu_torch.ops.placement_cuda")
        doc = {"argv": argv,
               "scan": K.schedule_batch_cuda.launches if K else 0,
               "repair": K.schedule_batch_repair_cuda.launches if K else 0,
               "release": K.release_batch_cuda.launches if K else 0,
               "cuda_initialized": torch.cuda.is_initialized(),
               "libcuda_mapped": _libcuda_mapped(os.getpid())}
        if serve:
            gauges = [r.export_gauges() for r in receivers]
            doc["hop"] = {
                "frames": sum(g["funnel_frames_received"] for g in gauges),
                "rows": sum(g["funnel_rows_received"] for g in gauges),
                "dup_rows": sum(g["funnel_dup_rows"] for g in gauges),
                "outcome_frames": sum(g["funnel_acks_sent"] for g in gauges),
                "steps": hop["steps"], "step_rows": hop["rows"],
                "step_syncs": hop["step_syncs"],
                "loop_syncs": hop["loop_syncs"]}
        else:
            doc["front_end"] = [f.export_gauges() for f in front_ends]
        with open(os.path.join(counts_dir, f"{os.getpid()}.json"), "w") as f:
            json.dump(doc, f)


@contextlib.contextmanager
def _loadgen_processes_counted(counts_dir):
    """Inside the block, a process the load generator starts as `python -m
    openwhisk_tpu_torch.tools.loadgen ARGS` runs as `chip_smoke.py
    --loadgen-process DIR ARGS` (the same `main()`, plus its counts)."""
    import os
    popen = subprocess.Popen
    module = ["-m", "openwhisk_tpu_torch.tools.loadgen"]

    def counted(cmd, *args, **kw):
        if list(cmd[1:3]) == module:
            cmd = [cmd[0], os.path.abspath(__file__), "--loadgen-process",
                   counts_dir, *cmd[3:]]
        return popen(cmd, *args, **kw)

    subprocess.Popen = counted
    try:
        yield
    finally:
        subprocess.Popen = popen


def _rungs(out):
    """Each measured row of a sweep (the rungs, then the re-measured
    headline): offered rate, its accounting and its verdict."""
    rows = [("rung", r) for r in out["sweep"]] + [("headline",
                                                   out["headline"])]
    return [dict(kind=kind, offered_rate=r["offered_rate"],
                 offered=r["offered"], completed=r["completed"],
                 errors=r["errors"], unfinished=r["unfinished"],
                 p50_ms=r["p50_ms"], p99_ms=r["p99_ms"],
                 throughput_per_sec=r["throughput_per_sec"],
                 fire_lag_max_ms=r["fire_lag_max_ms"],
                 retried=r.get("retried", False),
                 verdict=r["verdict"])
            for kind, r in rows]


@contextlib.contextmanager
def _steps_counted(TB):
    """Inside the block every `TpuBalancer` step of this process counts in
    the yielded dict: steps and the rows they placed."""
    counts = {"steps": 0, "rows": 0}
    undo = _count_steps(TB, counts)
    try:
        yield counts
    finally:
        undo()


def _sweep_attempt(loadgen, K, n_invokers):
    """One `sweep_balancer` on DEVICE at `n_invokers`, its launches and
    steps counted from 0. A fleet that does not register is reported as
    the attempt's `error` (the echo fleet's pinger spreads its pings over
    each second (a named cut); a burst of 10,000 overran the health topic's
    4,096)."""
    from openwhisk_tpu_torch.controller.loadbalancer import tpu_balancer as TB
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with _steps_counted(TB) as steps:
            out = loadgen.sweep_balancer(
                rate0=LOADGEN_RATE0, duration=LOADGEN_DURATION,
                max_doublings=LOADGEN_DOUBLINGS, n_invokers=n_invokers,
                device=_device_arg())
    except RuntimeError as e:
        if "fleet never became healthy" not in str(e):
            raise
        return dict(n_invokers=n_invokers, error=str(e),
                    seconds=time.perf_counter() - t0)
    launches = _launches(K)
    return dict(
        n_invokers=n_invokers, device=out["device"],
        sustained=out["sustained"],
        sustained_activations_per_sec=out["sustained_activations_per_sec"],
        sustained_offered_rate=out["sustained_offered_rate"],
        p50_ms=out["p50_ms"], p99_ms=out["p99_ms"],
        p99_bound_ms=out["p99_bound_ms"],
        latency_base=out["latency_base"], gc_tuned=out["gc_tuned"],
        rungs=_rungs(out), stage_budget=out["stage_budget"],
        tail_attribution=out["tail_attribution"], launches=launches,
        steps=steps["steps"],
        rows_a_step=steps["rows"] / steps["steps"] if steps["steps"] else None,
        seconds=time.perf_counter() - t0)


def _stopped_on_generator(attempt):
    """The sweep's last rung failed, and on the generator alone."""
    rungs = [r for r in attempt.get("rungs", ()) if r["kind"] == "rung"]
    return bool(rungs and rungs[-1]["verdict"]["failed"]
                and rungs[-1]["verdict"]["blames"] == "generator")


def _open_loop_sweep(K):
    """13a: the sweep at 10,000 invokers (BASELINE's fleet), which must
    register; rerun at 1,024 when it stopped on the generator alone (the
    fleet's pings share the generator's loop), at whichever rung, so that
    the balancer's upper rungs are driven and 13(c)'s rate is half of what
    one balancer sustains."""
    from openwhisk_tpu_torch.tools import loadgen
    attempts = [_sweep_attempt(loadgen, K, LOADGEN_INVOKERS[0])]
    for a in attempts:
        say("loadgen_sweep", **a)
    first = attempts[0]
    require("error" not in first,
            f"loadgen: the echo fleet registered "
            f"{LOADGEN_INVOKERS[0]} invokers: {first.get('error')}")
    if _stopped_on_generator(first):
        attempts.append(_sweep_attempt(loadgen, K, LOADGEN_INVOKERS[1]))
        say("loadgen_sweep", **attempts[-1])
    used = attempts[-1]
    require("error" not in used,
            f"loadgen: the echo fleet registered at {used['n_invokers']} "
            f"invokers: {used.get('error')}")
    for a in attempts:
        for r in a.get("rungs", ()):
            require(r["completed"] + r["errors"] + r["unfinished"]
                    == r["offered"],
                    f"loadgen: every activation of the {r['offered_rate']}/s "
                    f"{r['kind']} at {a['n_invokers']} invokers accounted "
                    f"for: {r}")
    require(used["device"] == DEVICE,
            f"loadgen: the sweep's balancer placed on {DEVICE}: "
            f"{used['device']}")
    require(used["sustained"],
            f"loadgen: the re-measured rate is sustained at "
            f"{used['n_invokers']} invokers: {used['rungs'][-1]}")
    require(DEVICE != "cuda" or (used["launches"]["scan"] > 0
                                 and used["launches"]["repair"] > 0),
            f"loadgen: the sweep launched the scan and the repair: "
            f"{used['launches']}")
    return attempts


def _loadgen_cli():
    """13b: the CLI as a process: exactly one JSON line, from DEVICE."""
    import os
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "openwhisk_tpu_torch.tools.loadgen",
         "--rate", "200", "--duration", "1", "--invokers", "16",
         "--device", DEVICE], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    require(out.returncode == 0 and len(lines) == 1,
            f"loadgen: the CLI exits 0 with one JSON line ({out.returncode}, "
            f"{len(lines)} lines): {out.stderr[-2000:]}")
    row = json.loads(lines[0])
    require(row.get("device") == DEVICE and not row.get("error"),
            f"loadgen: the CLI's line is from {DEVICE}: {lines[0][:500]}")
    head = row["headline"]
    return dict(seconds=seconds, device=row["device"],
                sustained=row["sustained"],
                activations_per_sec=row["sustained_activations_per_sec"],
                p50_ms=row["p50_ms"], p99_ms=row["p99_ms"],
                completed=head["completed"], offered=head["offered"],
                verdict=head["verdict"])


#: 13c's run length a worker, and its invokers (multiproc_fixed_rate's
#: defaults)
LOADGEN_SHARED_S, LOADGEN_SHARED_INVOKERS = 2.5, 16
#: 13c's least rate: where the funnel completed no row before its repair
#: (ROADMAP Queue 3 item 12), so the phase holds the repair there even
#: when (a)'s sweep stopped lower on a host's GC pauses
LOADGEN_SHARED_FAULT_RATE = 1000.0


def _shared_attempt(loadgen, rate):
    """One `multiproc_fixed_rate(shared=True)` at `rate`: one funnel
    process owns DEVICE, the workers are front ends; each process's
    launches and CUDA state as it exited, the funnel process's hop (frames
    and rows received, outcome frames, steps, rows a step, host syncs on
    its loop) and the rows each front end failed on retry exhaustion."""
    import os
    import shutil
    import tempfile
    counts = tempfile.mkdtemp(prefix="chip-smoke-loadgen-")
    try:
        t0 = time.perf_counter()
        with _loadgen_processes_counted(counts):
            out = loadgen.multiproc_fixed_rate(
                rate=rate, procs=LOADGEN_PROCS, shared=True,
                duration=LOADGEN_SHARED_S,
                n_invokers=LOADGEN_SHARED_INVOKERS, device=_device_arg())
        seconds = time.perf_counter() - t0
        procs = []
        for name in sorted(os.listdir(counts)):
            with open(os.path.join(counts, name)) as f:
                procs.append(json.load(f))
    finally:
        shutil.rmtree(counts, ignore_errors=True)
    funnel = [p for p in procs if "--serve-funnel" in p["argv"]]
    workers = [p for p in procs if "--funnel" in p["argv"]]
    hop = funnel[0]["hop"] if len(funnel) == 1 else {}
    offered = LOADGEN_PROCS * max(1, int(rate / LOADGEN_PROCS
                                         * LOADGEN_SHARED_S))
    line = dict(
        offered_rate=rate, procs=out["procs"], topology=out["topology"],
        seconds=seconds, sustained=out["sustained"],
        fleet_merged_sustained_per_sec=out["fleet_merged_sustained_per_sec"],
        offered=offered, completed=out["completed"], p50_ms=out["p50_ms"],
        p99_ms=out["p99_ms"], per_worker=out["per_worker"],
        funnel_launches={k: sum(p[k] for p in funnel)
                         for k in ("scan", "repair", "release")},
        hop=dict(hop, rows_a_step=(hop["step_rows"] / hop["steps"]
                                   if hop.get("steps") else None),
                 syncs_a_step=(hop["step_syncs"] / hop["steps"]
                               if hop.get("steps") else None)),
        rows_timed_out=sum(g["funnel_rows_timed_out"] for p in workers
                           for g in p["front_end"]),
        frame_retries=sum(g["funnel_frame_retries"] for p in workers
                          for g in p["front_end"]),
        workers_cuda=[{k: p[k] for k in ("cuda_initialized",
                                         "libcuda_mapped")}
                      for p in workers])
    line["completes_every_row"] = (
        line["completed"] == offered and line["rows_timed_out"] == 0
        and all("error" not in w for w in out["per_worker"]))
    say("loadgen_shared", **line)
    require(out["topology"] == "shared" and len(funnel) == 1
            and len(workers) == LOADGEN_PROCS,
            f"loadgen: one funnel process and {LOADGEN_PROCS} workers "
            f"reported: {[p['argv'] for p in procs]}; balancer stderr: "
            f"{out['balancer_stderr_tail']}")
    for w in out["per_worker"]:
        require("error" not in w, f"loadgen: a shared worker's error: {w}")
    for p in workers:
        require(not p["cuda_initialized"],
                f"loadgen: a funnel worker holds no CUDA context: {p}")
    require(DEVICE != "cuda" or all(line["funnel_launches"].values()),
            f"loadgen: the funnel process launched every kernel: "
            f"{line['funnel_launches']}")
    return line


def _single_at(loadgen, rate):
    """One balancer in this process at 13c's rate, invokers and run
    length (`sweep_balancer(fixed_rate=...)`): the rows a step that the
    funnel process's are read beside."""
    from openwhisk_tpu_torch.controller.loadbalancer import tpu_balancer as TB
    t0 = time.perf_counter()
    with _steps_counted(TB) as steps:
        out = loadgen.sweep_balancer(
            fixed_rate=rate, duration=LOADGEN_SHARED_S,
            n_invokers=LOADGEN_SHARED_INVOKERS, device=_device_arg())
    head = out["headline"]
    return dict(
        offered_rate=rate, sustained=out["sustained"],
        completed=head["completed"], offered=head["offered"],
        p50_ms=out["p50_ms"], p99_ms=out["p99_ms"], steps=steps["steps"],
        rows_a_step=steps["rows"] / steps["steps"] if steps["steps"] else None,
        seconds=time.perf_counter() - t0)


def _shared_topology(rate):
    """13c: the shared topology at `rate`, which must complete
    every row (none failed on the funnel's retries); again at an eighth of
    the rate only when it does not, for the record, before the phase
    fails. Both workers must complete work in each attempt."""
    from openwhisk_tpu_torch.tools import loadgen
    attempts = [_shared_attempt(loadgen, rate)]
    if not attempts[0]["completes_every_row"]:
        attempts.append(_shared_attempt(loadgen, rate / 8))
    for a in attempts:
        for w in a["per_worker"]:
            require((w.get("throughput_per_sec") or 0) > 0,
                    f"loadgen: each shared worker completed work at "
                    f"{a['offered_rate']}/s: {w}")
    first = attempts[0]
    single = _single_at(loadgen, first["offered_rate"])
    say("loadgen_single_at_shared_rate", **single,
        funnel_rows_a_step=first["hop"]["rows_a_step"])
    require(first["completes_every_row"],
            f"loadgen: the shared funnel completed every row at "
            f"{first['offered_rate']}/s, none failed on retry exhaustion: "
            f"{first['completed']} of {first['offered']}, "
            f"{first['rows_timed_out']} timed out")
    return attempts, single


@contextlib.contextmanager
def _non_200_watch(bad):
    """Inside the block every blocking invoke of the harness's client that
    answers other than 200 is kept in `bad` as (name, status, body), with
    the sandboxes' process states at that moment in `bad_states`."""
    from openwhisk_tpu_torch.performance import harness
    invoke = harness.Client.invoke

    async def watched(self, name, payload=None, blocking=True):
        status, body = await invoke(self, name, payload, blocking)
        if status != 200:
            bad.append((name, status, body, _sandbox_states()))
        return status, body

    harness.Client.invoke = watched
    try:
        yield
    finally:
        harness.Client.invoke = invoke


def _report_sim_failure(bad, log):
    """Beside a failed simulation, before the phase fails: the standalone's
    log tail (its in-process invoker's included) and, for each non-200,
    the sandboxes' states when it came back."""
    print(f"--- standalone log tail:\n{log.getvalue()[-3000:]}",
          file=sys.stderr)
    for name, status, body, states in bad[:8]:
        print(f"--- {status} from {name}: {json.dumps(body)[:1000]}\n"
              f"--- sandboxes then: {json.dumps(states)}", file=sys.stderr)


def _simulations(K):
    """13d: each simulation through `simulations.run` against its own
    standalone on DEVICE; every request must be a 200."""
    import io
    from openwhisk_tpu_torch.performance import simulations
    rows = []
    for name, requests, concurrency in SIMULATIONS:
        bad, log, out = [], io.StringIO(), io.StringIO()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with _non_200_watch(bad), contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(log):
                ok = simulations.run([name], requests, concurrency,
                                     port=_free_port(), device=_device_arg())
            row = json.loads(out.getvalue().strip().splitlines()[-1])
            require(ok and row["simulation"] == name and row["errors"] == 0
                    and row["requests"] == requests and not bad,
                    f"loadgen: every {name} request answered 200: {row}, "
                    f"{len(bad)} not 200")
        except Exception:
            _report_sim_failure(bad, log)
            raise
        rows.append(dict(row, concurrency=concurrency,
                         seconds=time.perf_counter() - t0,
                         launches=_launches(K)))
    return rows


def _owperf():
    """13d: owperf's CSV phases against a standalone on DEVICE."""
    import io
    from openwhisk_tpu_torch.performance import owperf
    out, log, argv = io.StringIO(), io.StringIO(), sys.argv
    sys.argv = ["owperf", "--samples", str(OWPERF_SAMPLES), "--ratio",
                str(OWPERF_RATIO), "--port", str(_free_port()),
                "--device", DEVICE]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(log):
            owperf.main()
    except Exception:
        print(f"--- owperf's standalone log tail:\n"
              f"{log.getvalue()[-3000:]}", file=sys.stderr)
        raise
    finally:
        sys.argv = argv
    lines = out.getvalue().strip().splitlines()
    head = lines[0].split(",")
    phases = {ln.split(",")[0]: dict(zip(head[1:], ln.split(",")[1:]))
              for ln in lines[1:]}
    require(list(phases) == ["action_e2e", f"rule_e2e_x{OWPERF_RATIO}",
                             "waitTime", "initTime", "duration"]
            and phases["action_e2e"]["samples"] == str(OWPERF_SAMPLES),
            f"loadgen: owperf's five CSV phases, every action sample: "
            f"{lines}; {log.getvalue()[-1000:]}")
    return dict(phases=phases, seconds=time.perf_counter() - t0)


def _placement_sweep(K):
    """13d: the placement sweep's rows, one device and 8 shards, and the
    scan kernel against its plain version."""
    import io
    from openwhisk_tpu_torch.performance import placement_sweep
    out, argv = io.StringIO(), sys.argv
    sys.argv = ["placement_sweep", "--sizes", *map(str, SWEEP_SIZES),
                "--sharded", "--kernel", "--batch", str(SWEEP_BATCH),
                "--iters", str(SWEEP_ITERS), "--device", DEVICE]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            placement_sweep.main()
    finally:
        sys.argv = argv
    rows = [json.loads(ln) for ln in out.getvalue().splitlines()]
    for config in ("single-device", "8-shard", "cuda-vs-plain"):
        got = [r["n_invokers"] for r in rows if r["config"] == config]
        require(got == list(SWEEP_SIZES),
                f"loadgen: placement_sweep's {config} rows for every size: "
                f"{got}")
    launches = _launches(K)
    require(DEVICE != "cuda" or (launches["scan"] > 0
                                 and launches["repair"] > 0),
            f"loadgen: placement_sweep launched both kernels: {launches}")
    return dict(rows=rows, launches=launches,
                seconds=time.perf_counter() - t0)


def _warmhit(K):
    """13d: BASELINE's quality bar through the kernels."""
    from openwhisk_tpu_torch.performance import warmhit
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = warmhit.simulate(**WARMHIT_ARGS, device=_device_arg())
    launches = _launches(K)
    require(out["decision_parity"] == 1.0
            and out["kernel_warm_rate"] == out["oracle_warm_rate"],
            f"loadgen: warm-hit parity 1.0, the kernel's warm rate the "
            f"oracle's: {out}")
    require(DEVICE != "cuda" or (launches["repair"] > 0
                                 and launches["release"] > 0),
            f"loadgen: warmhit's 128-row rounds launched the repair and "
            f"its churn the release kernel: {launches}")
    return dict(out, launches=launches, seconds=time.perf_counter() - t0)


def loadgen_phase(K):
    """Phase 13: the port's load generator and performance harness on the
    card (module docstring)."""
    t_phase = time.perf_counter()
    sweeps = _open_loop_sweep(K)
    cli = _loadgen_cli()
    say("loadgen_cli", **cli)
    shared, single = _shared_topology(max(
        sweeps[-1]["sustained_activations_per_sec"] / 2,
        LOADGEN_SHARED_FAULT_RATE))
    sims = _simulations(K)
    for row in sims:
        say("loadgen_simulation", **row)
    ow = _owperf()
    say("loadgen_owperf", **ow)
    sweep = _placement_sweep(K)
    say("loadgen_placement_sweep", **sweep)
    wh = _warmhit(K)
    say("loadgen_warmhit", **wh)
    line = dict(
        sweep_invokers=[a["n_invokers"] for a in sweeps],
        rows_a_step={"sweep": sweeps[-1]["rows_a_step"],
                     "single_at_shared_rate": single["rows_a_step"],
                     "funnel": [a["hop"]["rows_a_step"] for a in shared]},
        sustained_activations_per_sec=sweeps[-1][
            "sustained_activations_per_sec"],
        p50_ms=sweeps[-1]["p50_ms"], p99_ms=sweeps[-1]["p99_ms"],
        shared_per_sec=[a["fleet_merged_sustained_per_sec"]
                        for a in shared],
        launches={"sweep": sweeps[-1]["launches"],
                  "funnel": {k: sum(a["funnel_launches"][k]
                                    for a in shared)
                             for k in ("scan", "repair", "release")},
                  "simulations": {r["simulation"]: r["launches"]
                                  for r in sims},
                  "placement_sweep": sweep["launches"],
                  "warmhit": wh["launches"]},
        phase_s=time.perf_counter() - t_phase)
    say("loadgen", **line)
    return line


def leg():
    """`--leg`: one leg of a parent/change comparison inside one call, run
    from the root of each tree: phase 7's main run without the profile
    window and an 8b run without the recorder, of the package beside this
    script; one JSON line of their numbers."""
    from openwhisk_tpu_torch.controller.loadbalancer import tpu_balancer as TB
    from openwhisk_tpu_torch.ops import _build
    from openwhisk_tpu_torch.ops import placement_cuda as K
    _build.build(K.SOURCES)
    front, *_ = asyncio.run(_front_run(TB, K, None, "0", FRONT_WAVES,
                                       FRONT_TRICKLE, profile=False,
                                       flap=True))
    http, *_ = asyncio.run(_http_fleet_run(TB, K, full=False))
    print(json.dumps({"leg": {
        "front": {k: front[k] for k in ("activations_per_s", "step_ms_p50_p99",
                                        "placement_ms_p50_p99", "register_s",
                                        "failed", "books_full")},
        "http": {k: http[k] for k in ("invokes_per_s",
                                      "http_ms_p50_p99_concurrent",
                                      "step_ms_p50_p99", "n_bad",
                                      "server_cpu_ms_per_invoke")}}}))
    return 0


def main():
    if sys.argv[1:2] == ["--http-client"]:
        return http_client(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--leg"]:
        return leg()
    if sys.argv[1:2] == ["--deploy-controller"]:
        return deploy_controller(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--cold-standalone"]:
        return cold_standalone(sys.argv[2], sys.argv[3], int(sys.argv[4]))
    if sys.argv[1:2] == ["--loadgen-process"]:
        return loadgen_process(sys.argv[2], sys.argv[3:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from openwhisk_tpu_torch.controller.loadbalancer import tpu_balancer as TB
    from openwhisk_tpu_torch.ops import _build
    from openwhisk_tpu_torch.ops import placement as P
    from openwhisk_tpu_torch.ops import placement_cuda as K

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.build(K.SOURCES + ("grid_barrier", "cluster_barrier"))
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in _build.build_logs.items()}
    say("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    t0 = time.perf_counter()
    kres = kernel_phase(torch, P, K)
    kres["release"] = release_phase(torch, P, K)
    say("kernel_phase", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    summary, launches, profile, box, sbox, rbox = main_path_phase(torch, K,
                                                                  TB)
    say("main_phase", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    mk = main_path_kernel("repair", box, torch, P, K)
    sk = main_path_kernel("scan", sbox, torch, P, K)
    rk = main_path_release(rbox, torch, P, K)
    del box, sbox, rbox
    serial_cost("repair", torch, P, K)
    sserial = serial_cost("scan", torch, P, K)
    barrier_cost(torch, K, _build)
    cluster = cluster_cost(torch, K, _build)
    say("main_kernel_phase", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    wide = wide_phase(torch, P, K, TB)
    say("wide_phase", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    pinned = scan_pinned_phase(torch, K, TB)
    say("scan_pinned_phase", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    planes = planes_phase(torch)
    say("planes", **planes)
    say("planes_phase", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    front = front_phase(torch, P, K, TB)
    say("front_phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    planes_ab(TB, K)
    say("planes_ab_phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    quality = quality_phase(torch, P, K, TB, front)
    say("quality_phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    mesh = mesh_phase(torch, P, K, TB, card)
    say("mesh_phase", seconds=time.perf_counter() - t0)
    front_launches = {k: sum(seg["launches"][k] for seg in front.values())
                      for k in ("scan", "repair")}
    t0 = time.perf_counter()
    journal = journal_phase(torch, P, K, TB, front)
    say("journal_phase", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    standalone, http = http_phase(torch, P, K, TB)
    say("http_phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    restart_phase(TB, K)
    say("restart_phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    deploy = deploy_phase(TB, K)
    say("deploy_phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    cold = cold_phase(TB)
    say("cold_phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    absorb = absorb_phase(TB, K, P)
    say("absorb_phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    ha = ha_phase()
    say("ha_phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    tools = tools_phase()
    say("tools_phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    lg = loadgen_phase(K)
    say("loadgen_phase", seconds=time.perf_counter() - t0)
    lg_launches = {
        kind: {path: (sum(v[kind] for v in c.values())
                      if path == "simulations" else c[kind])
               for path, c in lg["launches"].items()}
        for kind in ("scan", "repair", "release")}

    scan = sk["plain"]
    rep = mk["plain"]
    kernels = [
        {"name": "placement_scan", "route": "cuda",
         "source": "openwhisk_tpu_torch/csrc/placement_scan.cu",
         "replaces": "openwhisk_tpu/ops/placement_pallas.py:244",
         "launches": launches["scan"],
         "front_launches": front_launches["scan"],
         "standalone_launches": standalone["launches"]["scan"],
         "http_launches": http["launches"]["scan"],
         "max_abs_err": max(kres["scan"]["err"], scan["max_abs_err"],
                            sk["penalized"]["max_abs_err"],
                            *(v["max_abs_err"] for v in sserial.values())),
         "B": sk["B"], "cluster": sk["cluster"], "ms": scan["ms"],
         "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
         "bound_by": scan["bound_by"], "key_evals": scan["key_evals"],
         "library_ms": None,
         "us_per_request": sserial["B256"]["us_per_request"],
         "main_path_ms": summary["scan_ms_per_launch"],
         **cluster,
         "serial": sserial, "memory_traffic": kres["scan"]["times"],
         "scan_pinned": {k: pinned[k] for k in
                         ("step_p50_ms", "kernel_ms_per_launch", "launches")},
         "penalized": sk["penalized"],
         "replay_launches": journal["replay_launches"]["scan"],
         "replay_ms": journal["replay_ms"]["scan"],
         "wide": {k: (v if k == "balancer" else
                      {f: v[f] for f in ("N", "A", "B", "valid_rows", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "cluster")})
                  for k, v in wide.items()},
         "wide_launches": wide["balancer"]["launches"]["scan"],
         "deploy_launches": deploy["launches"]["scan"],
         "deploy_replay_launches": deploy["replay_card"]["launches"]["scan"],
         "absorb_launches": absorb["launches"]["scan"],
         "absorb_replay_launches": sum(r["launches"]["scan"]
                                       for r in absorb["absorbs"]),
         "ha_active_active_launches": sum(
             v["scan"] for v in ha["active_active"]["launches"].values()),
         "ha_active_standby_launches":
             ha["active_standby"]["launches"]["scan"],
         "funnel_launches": ha["funnel"]["launches"][
             f"controller{FUNNEL_INSTANCES[0]}"]["scan"],
         "tools_launches": {n: v["scan"]
                            for n, v in tools["launches"].items()},
         "loadgen_launches": lg_launches["scan"],
         "quality_launches": quality["launches"]["scan"],
         "mesh_launches": mesh["launches"]["scan"],
         "cold_launches": {lbl: cold[lbl]["launches"]["scan"]
                           for lbl in ("prewarm_on", "prewarm_off")},
         "penalized_launches": quality["penalized_launches"]["scan"],
         "quality_penalized": quality["scan_pinned"]["kernel"]},
        {"name": "placement_repair", "route": "cuda",
         "source": "openwhisk_tpu_torch/csrc/placement_repair.cu",
         "replaces": "openwhisk_tpu/ops/placement_pallas.py:464",
         "launches": launches["repair"],
         "front_launches": front_launches["repair"],
         "standalone_launches": standalone["launches"]["repair"],
         "http_launches": http["launches"]["repair"],
         "wide_launches": wide["balancer"]["launches"]["repair"],
         "max_abs_err": max(kres["repair"]["err"], rep["max_abs_err"]),
         "B": mk["B"], "grid": mk["grid"], "ms": rep["ms"],
         "rounds": rep["rounds"], "ms_per_round": rep["ms_per_round"],
         "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
         "bound_by": rep["bound_by"], "key_evals": rep["key_evals"],
         "library_ms": None,
         "main_path_ms_per_launch": profile["repair_ms_per_launch"],
         "main_path_ms_per_round": profile["repair_ms_per_round"],
         "memory_traffic": kres["repair"]["times"],
         "penalized": mk["penalized"],
         "replay_launches": journal["replay_launches"]["repair"],
         "replay_ms": journal["replay_ms"]["repair"],
         "deploy_launches": deploy["launches"]["repair"],
         "deploy_replay_launches": deploy["replay_card"]["launches"]["repair"],
         "absorb_launches": absorb["launches"]["repair"],
         "absorb_replay_launches": sum(r["launches"]["repair"]
                                       for r in absorb["absorbs"]),
         "ha_active_active_launches": sum(
             v["repair"] for v in ha["active_active"]["launches"].values()),
         "ha_active_standby_launches":
             ha["active_standby"]["launches"]["repair"],
         "funnel_launches": ha["funnel"]["launches"][
             f"controller{FUNNEL_INSTANCES[0]}"]["repair"],
         "tools_launches": {n: v["repair"]
                            for n, v in tools["launches"].items()},
         "loadgen_launches": lg_launches["repair"],
         "quality_launches": quality["launches"]["repair"],
         "mesh_launches": mesh["launches"]["repair"],
         "cold_launches": {lbl: cold[lbl]["launches"]["repair"]
                           for lbl in ("prewarm_on", "prewarm_off")},
         "penalized_launches": quality["penalized_launches"]["repair"],
         "quality_penalized": quality["auto"]["kernel"]},
        {"name": "release_fold", "route": "cuda",
         "source": "openwhisk_tpu_torch/csrc/release_fold.cu",
         "replaces": "openwhisk_tpu/ops/placement.py:589",
         "replaces_note": "no Pallas kernel: the reference folds releases "
                          "inside its XLA step (release_batch, and "
                          "release_batch_vector at :600)",
         "launches": launches["release"],
         "max_abs_err": max(kres["release"]["err"], rk["max_abs_err"]),
         "R": rk["R"], "valid_rows": rk["valid_rows"], "ms": rk["ms"],
         "plain_ms": rk["plain_ms"], "vector_ms": rk["vector_ms"],
         "bound_ms": rk["bound_ms"], "bound_by": rk["bound_by"],
         "library_ms": None, "cases": kres["release"]["cases"],
         "device_us": rk["device_us"],
         "launch_floor": kres["release"]["launch_floor"],
         "times": kres["release"]["times"],
         "mesh_fused_step_launches":
             mesh["ops"]["fused_step"]["release_launches"]["mesh"],
         "loadgen_launches": lg_launches["release"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

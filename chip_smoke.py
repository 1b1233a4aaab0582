"""Drive sahara_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and nvcc.  In order it:

1. prints the card's name and power limit, builds the eight CUDA kernels
   from ``sahara_tpu_torch/kernels/csrc``, all nvcc runs at once, and prints
   each kernel's registers;
2. regenerates the ``bench.py`` workload from its seeds (40 MB reference,
   65,536 reads of 100 bp with 2 planted errors, both strands); phase
   ``cli`` begins: the reference goes into a one-record FASTA in a
   temporary directory, the port's CLI ``read_simulator`` writes the reads
   (they must equal the workload's) and its ``index`` builds the
   bidirectional index with its full-SA sidecar, which every later phase
   loads (``load_index``);
3. holds K1-K3 against their plain PyTorch versions on the card at the
   seed-and-verify path's shapes (exact equality: all integer), and times
   both: each kernel by the profiler's device time, warm and with L2
   flushed before each launch (the pass meets them cold), beside the
   wrapper's call time; K1 also by its device time in one index upload
   (the j-mer table's ten levels, its path); the seed bad mask (K2m) on
   K2's chunk with N planted and on one ``sv.mapped`` call's matrix;
   counts K3's SASS instructions per row of its steady loop by pipe
   (cuobjdump);
4. runs the seed-and-verify path — upload without the reversed table (the
   j-mer table build runs K1) and ``search_queries`` at e=2 edit distance —
   with the launch counts reset just before, checks every kernel was
   launched and the hit set against the JAX package's, then times three
   passes (the median is the result) and one pass split by stage;
5. uploads the index without the full suffix array and checks that the
   sampled LF-walk locate (K7) gives the same hits on the first 8,192
   reads, and runs Hamming seed-and-verify (K3's Hamming entry) on the
   first 8,192 reads, checking each hit's mismatches on the host;
6. holds K4 (table in shared memory) and K1 against the plain rank on the
   largest table K4 takes near 100,000 characters (a random text of that
   length: 3,126 occ rows, 200,064 B) at 262,144 positions, times both by
   device time, warm and cold, and reports the bytes K4 stages from L2 a
   launch (the table once per cluster of 2 CTAs: 13,204,224 B on 132 CTAs)
   and K4's device time with one warp of positions a CTA (its staging); holds
   K5 (the one-launch work-queue step) against the plain step on three
   queues of the workload's first chunk: the queue after phase 0, the
   largest queue, and a drain step of a search with the in-search cap;
   records the chunk's queue size per step; holds the dedup's two kernels
   (``kernels/dedup.py``) against their plain version, sz and kill count,
   on every queue the same chunk's h2-k2 search dedups, and times them on
   the median and the largest of those queues;
7. runs the work-queue path on the same workload with both occ tables on
   the card (``engine="workq"``, ``generator_name="optimum"``, as
   ``bench.py`` does): its hit set must equal the seed-and-verify path's
   (80,248 rows, same sha256); times three passes and counts its
   synchronising calls;
8. runs the seed-and-verify fallback: 1,024 reads with an N in a seed part
   of every 8th read, ``auto`` against ``workq`` on all of them and against
   the seed-and-verify rows on the reads without N;
9. runs the short-read workload (phase ``sv_e1``: 32,768 reads of 36 bp
   with 2 planted edits simulated from the same reference, both strands,
   k=3) through ``auto``, which takes one-error seed-and-verify (seeds by
   K5, verify by K3): the hit set against the JAX package's; K5 on that
   run's largest seed-search step and largest drain step and K3 on its
   largest verify call (m=36, k=3), each against its plain version and
   timed; three timed passes, a profiled pass, syncs, peak memory and the
   fallback share; the
   work-queue engine on the first 4,096 reads against the JAX package's
   work-queue rows there (7 hits fewer than seed-and-verify's, which a
   brute-force check confirms) and against seed-and-verify's, both timed; the
   same reads under Hamming distance against the JAX package's hit set
   with every hit's mismatches recounted, and K3h timed on that run's
   largest verify call like its 100 bp row;
   then phase ``approx``: the frontier engine (``engine="approx"``,
   ``generator_name="optimum"``, one K8 launch a step) over the whole
   workload on the same upload, the rows of its first 16,384 queries
   against the JAX package's (``JAX_APPROX_PREFIX_*``) and the whole row
   set beside seed-and-verify's, the difference printed; K8 against its
   plain step (live counts included) at every step of the first chunk's
   first attempt and of a whole pass (the retry searches' per-query caps
   included), timed on the widest step of chunk 0 (warm, cold, call,
   plain and the least-work bound) and over a pass; each search (caps,
   lanes, overflowing lanes: the retries search only the overflowing
   queries, pooled across chunks), three timed passes and their syncs; the
   CLI's
   ``search --engine approx`` of the first 4,096 strand queries against the
   JAX CLI's (``JAX_APPROX_CLI_*``);
   then phase ``mesh``: a data mesh of the card listed twice, the index
   replicated (one upload), the workload through ``auto`` (seed-and-verify
   with exact parts) and ``engine="workq"`` on the mesh, each against
   ``JAX_SHA256`` and timed beside the single-device pass on the same
   upload (three passes, a profiled one, the launches of each); phase 8's N
   reads on the mesh against their single-device rows; the short-read
   workload's first 4,096 reads through ``auto`` on the mesh, which takes
   the reference's mesh route, the work-queue engine, against
   ``JAX_E1_WORKQ_PREFIX_*`` (beside one device's SV-e1 rows); and
   ``distributed_scheme_search`` on chunk 0 against one ``scheme_search``
   (the whole ``SearchHits``);
10. phase ``cli`` goes on, the CLI run in this process (``run_cli``) so
   that the launch counts can be read: ``search -e 2 -d lev`` of the
   workload's reads on the card, its output byte-equal to the JAX
   package's CLI output (sha256 and line count recorded on the CPU,
   ``JAX_CLI_*``) and to the rows of step 4, with K1, K2 and K3 launched
   in it, timed end to end and by its stats block; the same with
   ``SAHARA_STREAM=1`` (the streaming path), byte-identical; then the
   conformance corpus through the port's ``read_simulator``, ``index``,
   ``rbi-index`` and ``rbi-index-dna4``, the 9 ``search`` and 2 ``rbi``
   golden cases with ``--device cuda``, each byte-equal to
   ``tests/goldens/``, and r2 with ``--engine workq`` on the card and on
   the CPU, byte-equal (K5 through the CLI);
   then phase ``sharded``: ``index --max_shard_mb 16`` of the same
   reference (3 shards, windows of 16,000,000 characters overlapping by
   4,096), the shards' sizes, the resident views' bytes beside the card's
   free memory and the budget, the CLI's ``search -e 2 -d lev`` on it
   byte-equal to ``JAX_SHARD_*`` and ``JAX_CLI_*``; ``search_queries_sharded``
   in process: resident (the 80,248 rows; K1 at each shard's upload, K2,
   K3; a warm pass, three timed, a profiled one), swap
   (``resident_budget=0``: the same rows, one pass, each shard's upload
   seconds), and phase 8's N reads, whose deferred fallback runs K5 on
   whole shards and gives phase 8's rows;
   then phase ``interval_mesh``: ``distributed_interval_search`` over the
   three shards, shard i on mesh entry i (the card three times), the
   workload against ``JAX_SHA256`` (K1 at each upload, K5, K7); phase
   ``multihost``: two ranks of the CLI's ``search -e 2 -d lev --mh_*``
   sharing the card, rank 0's merged file against ``JAX_CLI_*``, no part
   file left; phase ``corpus``: the synthetic genome of ``sim/corpus.py``
   (16 Mbp, N gaps, satellites, five records) through the CLI's ``index``,
   plain and ``--max_shard_mb 4``, its reads (less 82 low-complexity
   poly-A reads) through ``auto`` (with the fallback's share), ``workq``,
   ``approx`` and ``search_queries_sharded`` (resident, swap), each against
   ``JAX_CORPUS_*``; the poly-A reads through ``approx``, which overflows
   after its retries, and the work-queue engine's hit volume for them;
11. phase ``uni``: 65,536 error-free 100 bp reads through the port's
   ``read_simulator`` (read seed 99), ``uni-index`` of the reference and
   ``uni-search`` of the 131,072 strand queries on the card, its output
   byte-equal to the JAX package's CLI output (sha256 and lines recorded on
   the CPU, ``JAX_UNI_*``), K6 launched in it and K1 by the upload; the same
   queries through ``exact_search`` and ``locate`` on an upload without the
   full suffix array (K7 at sigma 6) give the same rows; phase ``kmer``:
   ``kmer-index --kmer 3 --window 4`` (sigma 32, 256 B occ rows) and
   ``kmer-search`` of the same reads, byte-equal to the JAX package's
   (``JAX_KMER_*``), K6 and K7 launched at sigma 32.  Each phase reports its
   stats blocks, wall time and reads/s, and holds K6 and K7 against their
   plain versions on its own recorded calls (exact equality), timed like the
   other kernels (K6 also without the j-mer table start, where the call has
   the table), with
   each call's longest chain of dependent steps and the distinct 32 B
   sectors its plain version touches (model figures, from the inputs);
   phase ``uni`` runs K6 with a table of empty intervals, which takes away
   the hit of every query the kernel starts from the table, and checks that
   those are the queries the rule names;
12. runs the rank bench (``sahara_tpu_torch/bench_rank.py``: K1 and K4 at
   100,000 characters, K1 alone at 4.6 million; device time and call time);
13. prints the kernels' JSON line (each kernel's figures at the sv_e1
   path's shape as its ``e1_*`` keys, beside that path's launches; K6's on
   the kmer path as ``kmer_*``, K7's on the uni path as ``uni_*``; K1's
   launches on the sharded paths, K8's device time in an approx pass), the
   count of profiler sessions and the kernels timed by CUDA events because
   the profiler recorded nothing (``timing.kernel_device_ms``), the card
   line, and as the last line
   ``{"ok": true, "device": {...}}``.  The full report goes to
   ``chiprun_out/chip_smoke.json``.

Any failure raises, and the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from sahara_tpu_torch import timing
from sahara_tpu_torch.timing import dev_ms, kernel_device_ms, kernel_device_total, time_ms

# The JAX package's hit set for this workload, recorded on the CPU with
# sahara_tpu: bench.load_workload() at its defaults (40 MB, 65,536 reads,
# 100 bp, e=2), reads interleaved with their reverse complements as in
# bench.py, then sahara_tpu.engine.driver._run_sv_grouped(k=2, edit=True,
# chunk=16384) on DeviceIndex.from_host(build_bifmindex([ref], 6, "d_dna5",
# rate=16)).  Rows (query, seq, pos, err) as int64, sorted
# lexicographically; sha256 of their bytes.  No query fell back to the
# work-queue engine, so the seed-and-verify hit set is the whole hit set.
JAX_HITS = 80248
JAX_SHA256 = "05a0ffc11e48aaecc4f5c0910bf8d6947aef16804e696903f291d3297e2d4f59"
BENCH_R05_HITS = 80248  # hits printed by bench.py in BENCH_r05.json

# The JAX package's hit sets for the short-read workload (the short36_e3
# rows of tools/bench_variants.py), recorded on the CPU with sahara_tpu:
# bench.make_reference(default_rng(1234), 40_000_000), simulate_reads(...,
# num_reads=32768, read_length=36, random_errors=2, seed=7), reads
# interleaved with their reverse complements, then search_queries(k=3,
# generator_name="optimum", engine="auto", chunk=16384) on
# DeviceIndex.from_host(build_bifmindex([ref], 6, "d_dna5", rate=16)): the
# one-error seed-and-verify route.  Rows and sha256 as for JAX_HITS; the
# whole workload under edit distance, its first 4,096 reads, and the whole
# workload under Hamming distance.
JAX_E1_HITS = 130503
JAX_E1_SHA256 = "c0251cd360fc25402347e9630b07734f958c217bd6afe0cd9455c37956615989"
JAX_E1_PREFIX_HITS = 16221
JAX_E1_PREFIX_SHA256 = "e8ec623c627e8c071e389b130b414cb1e023af7828a2515c5dfffd5c8d915e72"
JAX_E1_HAMMING_HITS = 13520
JAX_E1_HAMMING_SHA256 = "63f0c61554da25b586c6b82d28af80b2aa2eb383416f3b45e5489775f7b72a99"
# The JAX package's work-queue engine (engine="workq", the same call) on the
# first 4,096 reads: 16,214 rows, not seed-and-verify's 16,221.  It misses 7
# hits and gives one an error count above the least (3 for 2); a brute-force
# minimal-span edit distance over the text confirms seed-and-verify's rows,
# and the engine misses them with dedup off too.
JAX_E1_WORKQ_PREFIX_HITS = 16214
JAX_E1_WORKQ_PREFIX_SHA256 = "e44d9c07db5a3fd633346408031cc550cab5e95f41cedc8055858ce149cf4dff"

# The JAX package's CLI output for the bench.py workload, recorded on the CPU
# with sahara_tpu, from the repository's root, HOME pointed at a scratch
# directory and JAX_PLATFORMS=cpu:
#   ref.fasta: one record ">ref", one sequence line (line_length=0), the ranks
#     of make_reference(default_rng(1234), 40_000_000) as ACGT
#   python -m sahara_tpu read_simulator -i ref.fasta -o reads.fasta -n 65536 \
#       -l 100 -e 2 --seed 99 --fasta_line_length 0
#   python -m sahara_tpu index ref.fasta
#   python -m sahara_tpu search -q reads.fasta -i ref.fasta.idx -o out.txt -e 2 -d lev
# sha256 of out.txt's bytes and its line count.
JAX_CLI_SHA256 = "e6ba548efad46fc5065aa50ea7e50e7224722d532033ec92cd8b2c45e5ee1325"
JAX_CLI_LINES = 80248

# The JAX package's CLI output on the interval-sharded index (phase
# sharded), recorded on the CPU with sahara_tpu as JAX_CLI_* was, on the same
# ref.fasta and reads.fasta:
#   python -m sahara_tpu index ref.fasta --max_shard_mb 16
#   python -m sahara_tpu search -q reads.fasta -i ref.fasta.idx -o out.txt -e 2 -d lev
# (3 shards of 16,000,000-char windows overlapping by 4,096).  The sharded
# search finds the unsharded hit set: the same bytes as JAX_CLI_*.
JAX_SHARD_SHA256 = "e6ba548efad46fc5065aa50ea7e50e7224722d532033ec92cd8b2c45e5ee1325"
JAX_SHARD_LINES = 80248
SHARD_MB = 16

# The JAX package's frontier engine (phase approx), recorded on the CPU with
# sahara_tpu: the workload's strand queries as for JAX_HITS, their first
# APPROX_PREFIX (one chunk: the JAX frontier engine on the CPU is too slow for
# the whole workload), search_queries(k=2, engine="approx", generator_name="optimum",
# chunk=16384) on DeviceIndex.from_host(build_bifmindex([ref], 6, "d_dna5",
# rate=16)); rows and sha256 as for JAX_HITS.  And its CLI output, recorded as
# JAX_CLI_* was, on the first APPROX_CLI_QUERIES strand queries:
#   python -m sahara_tpu search -q reads.fasta -i ref.fasta.idx -o out.txt -e 2 -d lev \
#       --engine approx --limit_queries 4096
APPROX_PREFIX = 16384
JAX_APPROX_PREFIX_HITS = 10054
JAX_APPROX_PREFIX_SHA256 = "60bf0ba07b1bb964024ab658a745242c2062d6359dca3394df623af148dbdab6"
APPROX_CLI_QUERIES = 4096
JAX_APPROX_CLI_SHA256 = "ea5f3ab402de89b16eab7853634157431156f6c48239b16178d5d4ffca2a94d3"
JAX_APPROX_CLI_LINES = 2526

# The JAX package's CLI output of exact search (phase uni) and kmer search
# (phase kmer), recorded on the CPU with sahara_tpu as JAX_CLI_* was, on the
# same ref.fasta, with 65,536 error-free reads:
#   python -m sahara_tpu read_simulator -i ref.fasta -o reads.fasta -n 65536 \
#       -l 100 -e 0 --seed 99 --fasta_line_length 0
#   python -m sahara_tpu uni-index ref.fasta
#   python -m sahara_tpu uni-search -q reads.fasta -i ref.fasta.single.idx -o uni_out.txt
#   python -m sahara_tpu kmer-index ref.fasta --kmer 3 --window 4
#   python -m sahara_tpu kmer-search --query reads.fasta --index ref.fasta.kmer.idx --output kmer_out.txt
# sha256 of each output file's bytes and its line count.  kmer-index found
# 29 distinct minimizers (sigma 32) in a kmer text of 14,907,156 symbols.
JAX_UNI_SHA256 = "d08ed2bda9ad7366607dffeb46ee5f19ed30878a445d74ba4bbaa44111cdb271"
JAX_UNI_LINES = 73185
JAX_KMER_SHA256 = "ab23bdcfbb852597e072ba71177b1b9e4543390f227c3b0b3bfa1f5e20434661"
JAX_KMER_LINES = 74251
KMER_FLAGS = ["--kmer", "3", "--window", "4"]
KMER_SIGMA = 32

# Phase corpus: the synthetic genome of sahara_tpu_torch/sim/corpus.py
# (sim.workload.corpus_workload: make_genome(default_rng(21), 16,000,000) at
# its default densities, records of 4.4, 3.6, 3.0, 2.7 and 2.3 M chars,
# 16,640 reads of 100 bp with 2 planted errors simulated from them with seed
# 5, each followed by its reverse complement, less the 82 reads one of whose
# strands is 80% or more one base: 16,558 reads, 33,116 strand queries;
# sha256 of the concatenated records and of the strand queries below).  The
# JAX package's rows were recorded on the CPU with sahara_tpu, from the
# repository's root, HOME pointed at a scratch directory, JAX_PLATFORMS=cpu
# and `ulimit -v 30000000`: the same genome, reads and filter through
# sahara_tpu.sim.corpus.make_genome and
# sahara_tpu.sim.read_simulator.simulate_reads, then block by block of
# strand queries, each block's query_ids its global numbers (a query's rows
# depend on no other query in its call), the rows concatenated:
# search_queries(k=2, edit=True, chunk=16384) on
# DeviceIndex.from_host(build_bifmindex(records, 6, "d_dna5", rate=16)) in
# blocks of 2,048 (auto), the same with engine="workq",
# generator_name="optimum", and with engine="approx",
# generator_name="optimum" in blocks of 1,024 on the first
# CORPUS_APPROX_PREFIX strand queries (the JAX frontier engine on the CPU
# takes minutes a block, and 49 GB for a block of 16,384); and
# search_queries_sharded(build_sharded_bifmindex(records, 6, "d_dna5",
# rate=16, max_chars=4_000_000), k=2, edit=True, chunk=16384) in blocks of
# 2,048.  Whole, the JAX package's SV and work-queue paths outgrow a 62 GB
# host.  auto, workq and the sharded index give the
# same rows; the reference's two sharded regimes give the same rows, so the
# swap pass is held to the sharded hash.  Rows and sha256 as for JAX_HITS.
CORPUS_GENOME_SHA256 = "577d3eeee36a64b21d1ac18afb20cc3950a6f26bad713ebe2f891f7676f2eeff"
CORPUS_QUERIES_SHA256 = "6d2b3d79c3bb4e8d716e31c69d805b544d0952553236cc3dedc03c618ca353ea"
CORPUS_SHARD_MB = 4
CORPUS_APPROX_PREFIX = 2048
JAX_CORPUS_HITS = 970832
JAX_CORPUS_SHA256 = "c46606c2327a9fe9a84ca1c4c69c998d8426da1fd40a1728ace1ee7f7ce70a1a"
JAX_CORPUS_WORKQ_HITS = 970832
JAX_CORPUS_WORKQ_SHA256 = "c46606c2327a9fe9a84ca1c4c69c998d8426da1fd40a1728ace1ee7f7ce70a1a"
JAX_CORPUS_APPROX_PREFIX_HITS = 77544
JAX_CORPUS_APPROX_PREFIX_SHA256 = "7da8e77b18c9e617bf36cee2acacc350eff62194fd7f5f9202bdab566707b816"
JAX_CORPUS_SHARD_HITS = 970832
JAX_CORPUS_SHARD_SHA256 = "c46606c2327a9fe9a84ca1c4c69c998d8426da1fd40a1728ace1ee7f7ce70a1a"

# The conformance corpus and cases of tests/test_conformance.py (which
# imports the JAX package, so they are copied here; tests/test_torch_cli.py
# holds the copies equal): reads (count, length, errors, seed) simulated from
# a three-record reference, the 9 search cases and the 2 rbi cases, each
# byte-compared with its golden in tests/goldens/.
GOLDEN_SEQ_LENS = (700, 400, 250)
GOLDEN_SEED = 20260817
GOLDEN_READS = {"r0": (10, 50, 0, 1), "r1": (10, 60, 1, 2), "r2": (12, 80, 2, 3)}
GOLDEN_CASES = [
    ("e0_exact_ham.txt", "r0", ["-e", "0", "-d", "ham", "-g", "optimum"]),
    ("e1_lev_optimum.txt", "r1", ["-e", "1", "-d", "lev", "-g", "optimum"]),
    ("e2_lev_h2k2.txt", "r2", ["-e", "2", "-d", "lev", "-g", "h2-k2"]),
    ("e2_ham_pigeonopt.txt", "r2", ["-e", "2", "-d", "ham", "-g", "pigeon_opt"]),
    ("e2_lev_besthits.txt", "r2", ["-e", "2", "-d", "lev", "-g", "optimum", "-m", "besthits"]),
    ("besthits_ham.txt", "r2", ["-e", "2", "-d", "ham", "-g", "optimum", "-m", "besthits"]),
    ("e2_lev_maxhits2.txt", "r2", ["-e", "2", "-d", "lev", "-g", "optimum", "--max_hits", "2"]),
    ("e2_lev_dynamic.txt", "r2", ["-e", "2", "-d", "lev", "-g", "h2-k2", "--dynamic_generator"]),
    ("e1_lev_noreverse.txt", "r1", ["-e", "1", "-d", "lev", "-g", "optimum", "--no-reverse"]),
]
GOLDEN_RBI_CASES = [("rbi_e1.txt", "rbi-search", ".rbi.idx"), ("rbi4_e1.txt", "rbi-search-dna4", ".rbi4.idx")]
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")

K = 2
CHUNK = 16384
SAMPLED_READS = 8192
K1_POSITIONS = 1 << 20
WORKQ_GENERATOR = "optimum"  # bench.py's generator for the work-queue engine
DEDUP_GENERATOR = "h2-k2"  # the workq.mapped cell's scheme, whose queues the dedup phase records
FALLBACK_READS = 1024
SV_CALL_QUERIES = 865920  # strand queries of one call of the benchmark's sv.mapped cell
RANK_BENCH_POSITIONS = 262144  # bench_rank.py's default batch
SMEM_TEXT_MB = 0.1  # the largest random text whose occ table K4 takes
E1_K = 3  # the short-read workload's k: 36 // 4 < 10, so one-error seeds
E1_PREFIX_READS = 4096  # the work-queue engine's share of the short-read workload
MESH_ENTRIES = 2  # phase mesh: the card listed twice (the machine has one GPU)
EXACT_READS = 65536  # error-free reads of phases uni and kmer
# a kernel's figures at the sv_e1 path's shape, kept in its row as e1_<key>
E1_KEYS = ("max_abs_err", "ms", "cold_ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "lanes", "shape", "rows",
           "children", "hits", "candidates", "cases")

# H100 SXM HBM3 bytes/s (NVIDIA data sheet).  The kernels' operations are
# 32-bit integer ones.  An SM issues 4 warp instructions a clock (128
# lanes); its ALU pipes, which run compares, min/max, logic and shifts, take
# 64 lanes a clock (Hopper white paper), and an integer add may also go to
# the FMA pipes as an IMAD.  So a kernel's least time for its operations is
# the larger of its ALU-only operations over 64 lanes and all of them over
# 128, times the card's SMs and maximum SM clock, read at run time.
PEAK_BYTES_S = 3.35e12
ALU_LANES_PER_SM_CLOCK = 64
ISSUE_LANES_PER_SM_CLOCK = 128
# the edit DP's steady recurrence per cell: on the ALU, compare the chars,
# min of up and left, two fused add-and-min (VIADDMNMX: +1 and min for a,
# +1 and min for b); the substitution cost's add may run on either pipe
DP_ALU_OPS_PER_CELL = 4
DP_ADD_OPS_PER_CELL = 1
FLUSH_BYTES = 128 << 20  # written between launches to evict the 50 MB L2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def sm_clocks_s() -> float:
    """SM clocks a second over the card: SMs x maximum SM clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def steady_row_sass(src: str, entry: str, loads: int, rows: int) -> dict | None:
    """SASS instructions per row of the steady loop of function ``entry`` in
    the library of ``src`` (cuobjdump): the loop, closed by a backward
    branch, that issues ``loads`` global loads for ``rows`` rows.  Counted by
    pipe: IMAD and IMUL forms on the FMA pipe, loads, branches, and every
    other instruction on the ALU.  None where cuobjdump is missing."""
    from sahara_tpu_torch.kernels._build import lib_path, nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    dump = subprocess.run([tool, "-sass", lib_path(src)], capture_output=True, text=True, check=True).stdout
    body = next(part for part in dump.split("Function : ")[1:] if entry in part.split()[0])
    ins = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", body)]
    at = {a: i for i, (a, _) in enumerate(ins)}
    for i, (a, op) in enumerate(ins):
        jump = re.search(r"\bBRA\s+0x([0-9a-f]+)", op)
        if not jump or int(jump.group(1), 16) >= a:
            continue
        names = [re.sub(r"^@!?U?P\w+\s+", "", x).split()[0] for _, x in ins[at[int(jump.group(1), 16)]: i + 1]]
        n_loads = sum(x.startswith("LDG") for x in names)
        if n_loads != loads:
            continue
        fma = sum(x.startswith(("IMAD", "IMUL")) for x in names)
        branch = sum(x.startswith("BRA") for x in names)
        return dict(total=len(names) / rows, fma=fma / rows, alu=(len(names) - fma - n_loads - branch) / rows,
                    loads=n_loads / rows, branch=branch / rows, loop_instructions=len(names), rows=rows)
    raise AssertionError(f"no loop of {entry} with {loads} global loads")


def register_row(ptxas: dict, source: str, entry: str) -> str:
    """'N registers, S B spill stores' of the first entry of ``source``'s
    ptxas report whose mangled name contains ``entry``."""
    for row in registers(ptxas.get(source, "")):
        if entry in row.split(":")[0]:
            return row.split(": ", 1)[1]
    return "not reported"


def registers(report: str) -> list[str]:
    """'<entry>: N registers, S B spill stores' from a ptxas -v report."""
    rows, entry, spill = [], None, "?"
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry, spill = m.group(1), "?"
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = m.group(1)
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            rows.append(f"{entry}: {m.group(1)} registers, {spill} B spill stores")
            entry = None
    return rows


def bound(n_bytes: float, alu_ops: float, add_ops: float = 0) -> tuple[float, str]:
    """Least ms for ``n_bytes`` of memory traffic and ``alu_ops`` integer
    operations that only the ALU pipes run, plus ``add_ops`` that either
    pipe runs."""
    per_lane = 1e3 / (sm_clocks_s())
    t_ops = max(alu_ops / ALU_LANES_PER_SM_CLOCK, (alu_ops + add_ops) / ISSUE_LANES_PER_SM_CLOCK) * per_lane
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def assert_equal(name: str, got, want) -> int:
    """0 where ``got`` equals ``want`` (tensors, or tuples of them compared
    as one); raises otherwise."""
    got, want = (torch.cat(x) if isinstance(x, tuple) else x for x in (got, want))
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else "shape"
        raise AssertionError(f"{name}: kernel differs from its plain version ({bad} entries)")
    return 0


def sorted_rows(res) -> np.ndarray:
    rows = np.stack([res.query_id, res.seq_id, res.pos, res.errors], axis=1).astype(np.int64)
    return np.ascontiguousarray(rows[np.lexsort(rows.T[::-1])])


def require_rows(what: str, res, want: np.ndarray) -> None:
    """Raise unless the rows of ``res`` are ``want`` (``sorted_rows``)."""
    if not np.array_equal(sorted_rows(res), want):
        raise AssertionError(f"{what}: rows differ from the first pass's")


def seed_reads(index, queries: torch.Tensor, parts) -> tuple[int, int]:
    """(distinct occ rows, distinct table j-mers) the seed scan reads; the
    j-mers bound the table codes from above, since the scan clamps codes.

    Before the step that adds a part's t-th char from the end, the lane's
    interval is that of the part's last t chars, and hi = lo + sz (backward
    search never narrows below empty), so the plain scan of those suffixes
    gives the rows every step ranks at."""
    from sahara_tpu_torch.kernels.seed import seed_scan_plain

    j, seen = index.lut_j, []
    for t in range(j, max(ln for _, ln in parts)):
        suffixes = [(off + ln - t, t) for off, ln in parts if ln > t]
        lo, sz = seed_scan_plain(index.occ, index.c_arr, index.lut, j, queries, suffixes, index.sigma, index.n)
        seen += [lo.reshape(-1) >> 5, (lo + sz).reshape(-1) >> 5]
    jmers = torch.cat([queries[:, off + ln - j : off + ln] for off, ln in parts]).long()
    return torch.unique(torch.cat(seen)).numel(), torch.unique(jmers, dim=0).shape[0]


def shared_row_steps(index, queries: torch.Tensor, parts) -> float:
    """Share of the seed scan's rank steps whose two interval ends fall in
    one occ row (K2 then fetches one row, not two); the interval before
    each step comes from the plain scan of the part suffixes."""
    from sahara_tpu_torch.kernels.seed import seed_scan_plain

    j, same, total = index.lut_j, 0, 0
    for t in range(j, max(ln for _, ln in parts)):
        suffixes = [(off + ln - t, t) for off, ln in parts if ln > t]
        lo, sz = seed_scan_plain(index.occ, index.c_arr, index.lut, j, queries, suffixes, index.sigma, index.n)
        same += int(((lo >> 5) == ((lo + sz) >> 5)).sum())
        total += lo.numel()
    return same / total


def clean_windows(index, base: torch.Tensor, m: int) -> float:
    """Share of K3's (candidate, start) threads whose window text[p, p + m + k)
    lies inside the text and holds no rank-0 char: they run the fast loop."""
    from sahara_tpu_torch.kernels.verify import text_ranks

    p = base.long()[:, None] + torch.arange(2 * K + 1, device=base.device)
    span = torch.arange(m + K, device=base.device)
    inside = (p >= 0) & (p + m + K <= index.n)
    clean = torch.stack([(text_ranks(index.text4, index.n, p[:, d, None] + span) != 0).all(dim=1)
                         for d in range(2 * K + 1)], dim=1)
    return float((inside & clean).float().mean())


def profile_pass(run) -> dict:
    """Device busy time and the heaviest ops of one pass (torch.profiler),
    and the heaviest host functions (cProfile, a second pass)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # device-side events only (kernels and copies); the profiler's own
    # buffer requests are not the program's work
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and "Activity Buffer" not in e.key]
    out = {
        "device_busy_ms": sum(dev_ms(e) for e in dev),
        "top_device_ms": [(e.key[:120], dev_ms(e), e.count) for e in sorted(dev, key=dev_ms, reverse=True)[:8]],
    }
    prof_host = cProfile.Profile()
    prof_host.enable()
    run()
    torch.cuda.synchronize()
    prof_host.disable()
    stats = pstats.Stats(prof_host).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:10]
    out["top_host_tottime_ms"] = [(f"{f[0].split('/')[-1]}:{f[1]}:{f[2]}", v[2] * 1e3, v[1]) for f, v in top]
    return out


def kernel_times(call, name: str, flush) -> dict:
    """Device ms per launch of kernel ``name`` through ``call``, warm (back
    to back) and cold (L2 flushed before each launch), and the wrapper's
    call time."""
    return dict(ms=kernel_device_ms(call, name, 20), cold_ms=kernel_device_ms(call, name, 20, before=flush),
                call_ms=time_ms(call, 20))


def print_times(row: dict) -> None:
    """A kernel's device times."""
    print(f"{row['name']}: device warm {row['ms']:.4f} / cold {row['cold_ms']:.4f} ms, call "
          f"{row['call_ms']:.4f} ms, {row.get('registers', '')}", flush=True)


def kernel_phases(index, queries: np.ndarray, rng: np.random.Generator, ref: np.ndarray,
                  ptxas: dict) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes."""
    from sahara_tpu_torch.engine.locate import expand_intervals, lf_walk
    from sahara_tpu_torch.engine.seedverify import plan_parts, seed_parts
    from sahara_tpu_torch.kernels._build import source
    from sahara_tpu_torch.kernels.rank import rank_all, rank_all_plain
    from sahara_tpu_torch.kernels.seed import seed_bad_mask_kernel, seed_bad_mask_plain, seed_scan, seed_scan_plain
    from sahara_tpu_torch.kernels.verify import verify, verify_plain

    dev, sigma, n = index.device, index.sigma, index.n
    rows = []
    flush_buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    flush = lambda: flush_buf.fill_(1)  # noqa: E731

    # K1 at 1M random positions over the whole occ table (larger than L2)
    idx = torch.from_numpy(rng.integers(0, n + 1, K1_POSITIONS).astype(np.int32)).to(dev)
    want = rank_all_plain(index.occ, sigma, idx)
    err = assert_equal("rank_all", rank_all(index.occ, sigma, idx), want)
    call = lambda: rank_all(index.occ, sigma, idx)  # noqa: E731
    rows_read = torch.unique(idx >> 5).numel()
    b, by = bound(rows_read * 64 + K1_POSITIONS * (4 + 4 * sigma), K1_POSITIONS * sigma * 3)
    rows.append(dict(
        name="rank_all", route="cuda", source="sahara_tpu_torch/kernels/csrc/rank.cu",
        replaces="sahara_tpu/kernels/rank.py:218", max_abs_err=err,
        **kernel_times(call, "rank_all_kernel", flush),
        plain_ms=time_ms(lambda: rank_all_plain(index.occ, sigma, idx), 5),
        bound_ms=b, bound_by=by, library_ms=None, registers=register_row(ptxas, "rank", "rank_all_kernelILi6E"),
        occ_rows_read=rows_read,
        shape=f"{K1_POSITIONS} positions, sigma={sigma}",
    ))

    # K2 on one chunk of reads cut from the reference at random, 2 random
    # substitutions each (the chunk's own shape: 16,384 reads x 3 parts)
    m = queries.shape[1]
    parts = plan_parts(m, K)
    at = rng.integers(0, len(ref) - m, CHUNK)
    qs = ref[at[:, None] + np.arange(m)]
    for _ in range(K):
        col = rng.integers(0, m, CHUNK)
        qs[np.arange(CHUNK), col] = rng.integers(1, 5, CHUNK)
    qd = torch.from_numpy(np.ascontiguousarray(qs, dtype=np.uint8)).to(dev)
    args = (index.occ, index.c_arr, index.lut, index.lut_j, qd, parts, sigma, n)
    lo, sz = seed_scan(*args)
    lo_p, sz_p = seed_scan_plain(*args)
    err = assert_equal("seed_scan lo", lo, lo_p) + assert_equal("seed_scan sz", sz, sz_p)
    steps = sum(ln - index.lut_j for _, ln in parts)
    rows_read, codes_read = seed_reads(index, qd, parts)
    b, by = bound(rows_read * 64 + codes_read * 8 + CHUNK * (m + len(parts) * 8), CHUNK * 2 * steps * 4)
    rows.append(dict(
        name="seed_scan", route="cuda", source="sahara_tpu_torch/kernels/csrc/seed.cu",
        replaces="sahara_tpu/engine/seedverify.py:158", max_abs_err=err,
        **kernel_times(lambda: seed_scan(*args), "seed_scan_kernel", flush),
        plain_ms=time_ms(lambda: seed_scan_plain(*args), 3), bound_ms=b, bound_by=by, library_ms=None,
        registers=register_row(ptxas, "seed", "seed_scan_kernel"),
        shape=f"{CHUNK} reads x {len(parts)} parts", shared_row_steps=shared_row_steps(index, qd, parts),
    ))

    # K2m, the seed bad mask: on K2's chunk with an N in every 8th read's
    # first table-covered suffix, then on one sv.mapped call's matrix (the
    # chunk tiled to 865,920 strand queries), which it scans once a call
    j = index.lut_j
    qn = qd.clone()
    qn[::8, parts[0][0] + parts[0][1] - 1] = 5
    flags = seed_bad_mask_kernel(qn, parts, j)
    err = assert_equal("seed_bad_mask", flags, seed_bad_mask_plain(qn, parts, j))
    if int(flags.sum()) < CHUNK // 8:
        raise AssertionError("seed_bad_mask missed the planted N")
    big = qd.repeat(-(-SV_CALL_QUERIES // CHUNK), 1)[:SV_CALL_QUERIES]
    margs = (big, parts, j)
    err += assert_equal("seed_bad_mask call", seed_bad_mask_kernel(*margs), seed_bad_mask_plain(*margs))
    b, by = bound(big.numel() + SV_CALL_QUERIES, 0)  # the matrix in, a flag a query out
    rows.append(dict(
        name="seed_bad_mask", route="cuda", source="sahara_tpu_torch/kernels/csrc/seed.cu",
        replaces="sahara_tpu/engine/seedverify.py:114", max_abs_err=err,
        **kernel_times(lambda: seed_bad_mask_kernel(*margs), "bad_mask_kernel", flush),
        plain_ms=time_ms(lambda: seed_bad_mask_plain(*margs), 3), bound_ms=b, bound_by=by, library_ms=None,
        registers=register_row(ptxas, "seed", "bad_mask_kernel"),
        shape=f"{SV_CALL_QUERIES} queries x {m}, {len(parts)} parts x {j} covered chars",
        chunk_ms=kernel_device_ms(lambda: seed_bad_mask_kernel(qd, parts, j), "bad_mask_kernel", 20),
    ))

    # K3 on the real candidates of the workload's first chunk
    qc = torch.from_numpy(np.ascontiguousarray(queries[:CHUNK], dtype=np.uint8)).to(dev)
    lo, sz = seed_parts(index, qc, parts)
    n_cands = int(sz.sum().item())
    cand_rows, src, valid, _ = expand_intervals(lo.reshape(-1), sz.reshape(-1), n_cands)
    seq_id, pos = lf_walk(index, cand_rows, valid)
    offs = torch.tensor([off for off, _ in parts], device=dev)
    a0 = index.seq_starts[seq_id.long()].long() + pos.long() - offs[src % len(parts)]
    q_of = (src // len(parts)).to(torch.int32)
    base = (a0 - K).to(torch.int32)
    vargs = (index.text4, n, qc, q_of, base, K, True)
    err = assert_equal("verify", verify(*vargs), verify_plain(*vargs))
    s_cnt = 2 * K + 1
    b, by = edit_bound(vargs)
    rows.append(dict(
        name="verify", route="cuda", source="sahara_tpu_torch/kernels/csrc/verify.cu",
        replaces="sahara_tpu/engine/seedverify.py:330", max_abs_err=err,
        plain_ms=time_ms(lambda: verify_plain(*vargs), 2), bound_ms=b, bound_by=by, library_ms=None,
        shape=f"{n_cands} candidates x {s_cnt} starts, m={m}, k={K}",
        **kernel_times(lambda: verify(*vargs), "edit_kernel", flush),
        registers=register_row(ptxas, "verify", "edit_kernelILi2E"), fast_windows=clean_windows(index, base, m),
        # the steady loop loads one text and two query words per 8 rows
        steady_row_sass=steady_row_sass(source("verify"), "edit_kernelILi2E", 3, 8),
    ))
    rows.append(dict(
        name="verify_hamming", route="cuda", source="sahara_tpu_torch/kernels/csrc/verify.cu",
        replaces="sahara_tpu/engine/seedverify.py:330", library_ms=None,
        registers={g: register_row(ptxas, "verify", f"hamming_kernelILi{g}E") for g in (1, 2, 4, 8)},
        **hamming_times((index.text4, n, qc, q_of, a0.to(torch.int32), K, False), flush),
    ))
    return rows


def edit_bound(vargs) -> tuple[float, str]:
    """The bound of K3 (edit) on ``vargs`` (``verify``'s arguments)."""
    _, n, queries, q_of, base, k, _ = vargs
    n_cands, m, s_cnt = q_of.shape[0], queries.shape[1], 2 * k + 1
    # chars read: base .. base + S - 1 + m + k - 1
    span = torch.arange(s_cnt + m + k - 1, device=base.device)
    words = torch.unique((base.long()[:, None] + span).clamp(0, n - 1) >> 3).numel()
    cells = n_cands * s_cnt * m * (2 * k + 1)
    return bound(words * 4 + torch.unique(q_of).numel() * m + n_cands * (8 + 4 * s_cnt),
                 cells * DP_ALU_OPS_PER_CELL, cells * DP_ADD_OPS_PER_CELL)


def hamming_times(vargs, flush) -> dict:
    """K3h on ``vargs`` (``verify``'s arguments, Hamming): held against its
    plain version; its device time warm and cold, its call time, the plain
    version's time and the bound."""
    from sahara_tpu_torch.kernels.verify import hamming_lanes, verify, verify_plain

    text4, n, queries, q_of, base, _, _ = vargs
    want = verify_plain(*vargs)
    err = assert_equal("verify_hamming", verify(*vargs), want)
    call = lambda: verify(*vargs)  # noqa: E731
    n_cands, m = q_of.shape[0], queries.shape[1]
    words = torch.unique((base.long()[:, None] + torch.arange(m, device=base.device)).clamp(0, n - 1) >> 3).numel()
    # each window word, each distinct query, q_of, base and dist once; a
    # compare, a sentinel test and an add a char
    b, by = bound(words * 4 + torch.unique(q_of).numel() * m + n_cands * 12, n_cands * m * 3)
    return dict(
        max_abs_err=err, **kernel_times(call, "hamming_kernel", flush),
        lanes=hamming_lanes(n_cands, m), plain_ms=time_ms(lambda: verify_plain(*vargs), 2), bound_ms=b,
        bound_by=by, shape=f"{n_cands} candidates, m={m}",
    )


def smem_phase(dev) -> dict:
    """K4 and K1 against the plain rank on the largest table K4 takes, both
    by device time, warm and cold."""
    from sahara_tpu_torch.bench_rank import setup
    from sahara_tpu_torch.kernels.rank import rank_all, rank_all_plain
    from sahara_tpu_torch.kernels.rank_smem import launch_shape, rank_all_smem

    occ16, sigma, idx = setup(SMEM_TEXT_MB, RANK_BENCH_POSITIONS, dev)
    want = rank_all_plain(occ16, sigma, idx)
    err = assert_equal("rank_all_smem", rank_all_smem(occ16, sigma, idx), want)
    call = lambda: rank_all_smem(occ16, sigma, idx)  # noqa: E731
    assert_equal("rank_all on K4's table", rank_all(occ16, sigma, idx), want)
    n, table = idx.shape[0], occ16.numel() * 4
    # each position read once, each rank written once, the table read once
    b, by = bound(n * (4 + 4 * sigma) + table, n * sigma * 3)
    flush_buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    flush = lambda: flush_buf.fill_(1)  # noqa: E731
    k1 = kernel_times(lambda: rank_all(occ16, sigma, idx), "rank_all_kernel", flush)
    shape = launch_shape(n, sigma)
    # one warp of positions per CTA: the launch is then its table staging
    few = idx[: 32 * shape["ctas"]].contiguous()
    staging = lambda: rank_all_smem(occ16, sigma, few)  # noqa: E731
    return dict(
        name="rank_all_smem", route="cuda", source="sahara_tpu_torch/kernels/csrc/rank_smem.cu",
        replaces="sahara_tpu/kernels/rank.py:108", max_abs_err=err,
        **kernel_times(call, "rank_smem_kernel", flush),
        plain_ms=time_ms(lambda: rank_all_plain(occ16, sigma, idx), 5),
        bound_ms=b, bound_by=by, library_ms=None,
        k1_ms_same_inputs=k1["ms"], k1_cold_ms_same_inputs=k1["cold_ms"], k1_call_ms_same_inputs=k1["call_ms"],
        # the L2 serves the table once per cluster
        launch=shape, l2_staging_bytes=table * shape["ctas"] // shape["cluster_ctas"],
        staging_ms=kernel_device_ms(staging, "rank_smem_kernel", 20),
        shape=f"{n} positions, {occ16.shape[0]} occ rows ({table} B), sigma={sigma}",
    )


def capped_rows(ctx, state) -> int:
    """Live rows of ``state`` whose query has reached the in-search cap."""
    q_id = ctx.layout.decode(state[3])[4]
    return int(((ctx.hq_counts[q_id.long()] >= ctx.cap_per_query) & (state[2] > 0)).sum())


def step_case(ctx, state, drain: bool, what: str) -> dict:
    """K5 on one recorded step input against its plain step: its device and
    call times, the plain step's time and the bound."""
    from sahara_tpu_torch.kernels.workq import n_branches, workq_step, workq_step_plain

    got = workq_step(ctx, *state, drain=drain)
    want = workq_step_plain(ctx, *state, drain=drain)
    err = sum(assert_equal(f"workq_step ({what}) {f}", a, b)
              for f, a, b in zip(("lb", "lbr", "sz", "meta", "hits"), got, want))
    lb, lbr, sz, meta = state
    m, n, n_kids, n_hits = ctx.m, sz.shape[0], got[0].shape[0], got[4].shape[1]
    _, _, d, s_id, q_id = ctx.layout.decode(meta)
    alive = sz > 0
    if drain:
        alive &= d < m
        if ctx.cap_per_query:
            alive &= ctx.hq_counts[q_id.long()] < ctx.cap_per_query
    side = ctx.tape[(q_id.long() * ctx.ns + s_id) * m + d.clamp(max=m - 1)] & 1
    primary = torch.where(side == 1, lbr, lb).long()
    woff = side.long() * ctx.rev_off
    occ_rows = torch.unique(torch.cat([(primary >> 5) + woff, ((primary + sz) >> 5) + woff])[alive.repeat(2)])
    e_used = n_branches(ctx.sl, ctx.edit)
    # state and tape word per row, each distinct occ row, children and hits written
    b, by = bound(n * 20 + occ_rows.numel() * 64 + (n_kids + n_hits) * 16,
                  n * (6 * ctx.sigma + 4 * e_used) + n_kids * 8)
    step = lambda: workq_step(ctx, *state, drain=drain)  # noqa: E731
    out = dict(
        what=what, drain=drain, cap_per_query=ctx.cap_per_query, m=m, rows=n, children=n_kids, hits=n_hits,
        capped_rows=capped_rows(ctx, state) if ctx.cap_per_query else 0, max_abs_err=err,
        ms=kernel_device_ms(step, "step_kernel", 20), call_ms=time_ms(step, 20),
        plain_ms=time_ms(lambda: workq_step_plain(ctx, *state, drain=drain), 3), bound_ms=b, bound_by=by,
        occ_rows=occ_rows.numel(),
    )
    print(f"workq_step ({what}): {n} rows, {n_kids} children, {n_hits} hits: device {out['ms']:.4f} ms, call "
          f"{out['call_ms']:.4f} ms, plain {out['plain_ms']:.3f} ms, bound {b:.5f} ms by {by}", flush=True)
    return out


def workq_step_phase(index, queries: np.ndarray) -> tuple[dict, dict]:
    """K5 against its plain step on three queues of the first chunk's
    work-queue search (dedup on, as the path runs it): (a) after phase 0,
    (b) the largest, (c) the drain step with the most capped rows of a
    search with the in-search cap at 1.  Returns the kernel row and the
    chunk's queue size per step."""
    from sahara_tpu_torch.engine import workq
    from sahara_tpu_torch.engine.driver import load_scheme
    from sahara_tpu_torch.engine.tape import compile_tape

    dev, m = index.device, queries.shape[1]
    tape = compile_tape(load_scheme(WORKQ_GENERATOR, 0, K, m, edit=True, sigma=index.sigma, n_text=index.n))
    qd = torch.from_numpy(np.ascontiguousarray(queries[:CHUNK])).to(dev)
    ph0 = workq.phase0_length(tape, True)

    def search(cap: int, keep) -> list[int]:
        """Run the chunk's search; ``keep`` sees each step's input first.
        Returns the queue size per step."""
        sizes, expand_step = [], workq.expand_step

        def recorded(ctx, state, *, drain=False):
            sizes.append(state[2].shape[0])
            keep(len(sizes) - 1, ctx, state, drain)
            return expand_step(ctx, state, drain=drain)

        workq.expand_step = recorded
        try:
            workq.workq_search(index, qd, workq.upload_tape(tape, dev), torch.ones(CHUNK, dtype=torch.bool, device=dev),
                               edit=True, k=tape.max_errors, ph0=ph0, dedup_every=workq.DEDUP_EVERY,
                               cap_per_query=cap)
        finally:
            workq.expand_step = expand_step
        return sizes

    cases: dict = {}  # label -> (step, context, input queue, drain, pre-step hit counts)

    def keep_uncapped(g, ctx, state, drain):
        if g == ph0:
            cases["a"] = (g, ctx, state, drain, None)
        if "b" not in cases or state[2].shape[0] > cases["b"][2][2].shape[0]:
            cases["b"] = (g, ctx, state, drain, None)

    most_capped = [0]

    def keep_capped(g, ctx, state, drain):
        if drain and capped_rows(ctx, state) > most_capped[0]:
            most_capped[0] = capped_rows(ctx, state)
            cases["c"] = (g, ctx, state, drain, ctx.hq_counts.clone())

    sizes = search(0, keep_uncapped)
    search(1, keep_capped)
    if "c" not in cases:
        raise AssertionError("no drain step of the capped search had a capped row")
    peak = int(np.argmax(sizes))
    profile = dict(sizes=sizes, peak_rows=sizes[peak], peak_step=peak, ph0=ph0, steps=len(sizes))
    print(f"chunk 0 queue: {len(sizes)} steps, {sizes[ph0]} rows after phase 0 ({ph0} steps), peak {sizes[peak]} "
          f"rows at step {peak}", flush=True)

    out = []
    for label, what in (("a", "after phase 0"), ("b", "largest queue"), ("c", "capped drain step")):
        g, ctx, state, drain, counts = cases[label]
        if counts is not None:
            ctx.hq_counts.copy_(counts)
        out.append(dict(case=label, step=g, **step_case(ctx, state, drain, f"{what}, step {g}")))
    a = out[0]
    row = dict(
        name="workq_step", route="cuda", source="sahara_tpu_torch/kernels/csrc/workq.cu",
        replaces="sahara_tpu/engine/workq.py:702", max_abs_err=sum(c["max_abs_err"] for c in out),
        ms=a["ms"], call_ms=a["call_ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"], bound_by=a["bound_by"],
        library_ms=None, cases=out,
        shape=f"{a['rows']} rows after phase 0 ({ph0} steps) of {qd.shape[0]} strand queries, {a['children']} "
              f"children, sl={ctx.sl}",
    )
    return row, profile


def dedup_case(ctx, queue, flush, what: str) -> dict:
    """The dedup kernels on one recorded queue: device time (``dedup_elect``
    plus ``dedup_kill``, warm and cold), call time, the plain version's time
    and the bound."""
    from sahara_tpu_torch.kernels.dedup import workq_dedup, workq_dedup_plain

    n, live = queue[2].shape[0], int((queue[2] > 0).sum())
    call = lambda: workq_dedup(ctx, *queue)  # noqa: E731
    # what the function needs: each row's state once (lb, lbr, sz, meta) and
    # its sz out, a live row's table entry written by the atomic and read
    # back; the two-launch design reads the state a second time in the kill
    b, by = bound(n * 20 + live * 16, 0)
    elect, kill = (kernel_device_ms(call, name, 20) for name in ("dedup_elect", "dedup_kill"))
    cold = sum(kernel_device_ms(call, name, 20, before=flush) for name in ("dedup_elect", "dedup_kill"))
    out = dict(what=what, rows=n, live=live, ms=elect + kill, elect_ms=elect, kill_ms=kill, cold_ms=cold,
               call_ms=time_ms(call, 20), plain_ms=time_ms(lambda: workq_dedup_plain(ctx, *queue), 3), bound_ms=b,
               bound_by=by, bound_bytes=n * 20 + live * 16, two_launch_bytes=n * 36 + live * 16)
    print(f"workq_dedup ({what}): {n} rows, {live} live: device {elect:.5f} + {kill:.5f} ms (cold {cold:.5f}), "
          f"call {out['call_ms']:.4f} ms, plain {out['plain_ms']:.3f} ms, bound {b:.5f} ms by {by}", flush=True)
    return out


def workq_dedup_phase(index, queries: np.ndarray) -> dict:
    """The dedup kernels (``kernels/dedup.py``) against their plain version
    on every queue the first chunk's h2-k2 search (the scheme of the
    ``workq.mapped`` cell) dedups: the kernels' sz equal to the plain
    version's and their kills (``ctx.counters[3]``) to its count; timed on
    the median and the largest of those queues.  Returns the kernel row."""
    from sahara_tpu_torch.engine import workq
    from sahara_tpu_torch.engine.driver import load_scheme
    from sahara_tpu_torch.engine.tape import compile_tape
    from sahara_tpu_torch.kernels import LAUNCHES
    from sahara_tpu_torch.kernels.dedup import workq_dedup, workq_dedup_plain

    dev, m = index.device, queries.shape[1]
    tape = compile_tape(load_scheme(DEDUP_GENERATOR, 0, K, m, edit=True, sigma=index.sigma, n_text=index.n))
    chunk = min(CHUNK, workq.max_chunk_queries(m, tape.num_searches, tape.max_errors, True))
    qd = torch.from_numpy(np.ascontiguousarray(queries[:chunk])).to(dev)
    queues, engine_dedup = [], workq.workq_dedup

    def recorded(ctx, *queue):
        queues.append((ctx, queue))
        return engine_dedup(ctx, *queue)

    workq.workq_dedup = recorded
    try:
        workq.workq_search(index, qd, workq.upload_tape(tape, dev), torch.ones(chunk, dtype=torch.bool, device=dev),
                           edit=True, k=tape.max_errors, ph0=workq.phase0_length(tape, True),
                           dedup_every=workq.DEDUP_EVERY)
    finally:
        workq.workq_dedup = engine_dedup
    if not queues:
        raise AssertionError("the h2-k2 search made no dedup")
    kills = 0
    for i, (ctx, queue) in enumerate(queues):
        before, counted, plain_counted = LAUNCHES["workq_dedup"], int(ctx.counters[3]), ctx.dedup_kills
        got = workq_dedup(ctx, *queue)
        assert_equal(f"workq_dedup (dedup {i}) sz", got, workq_dedup_plain(ctx, *queue))
        if LAUNCHES["workq_dedup"] != before + 1 or int(ctx.counters[3]) - counted != ctx.dedup_kills - plain_counted:
            raise AssertionError(f"workq_dedup (dedup {i}): the kernels' kill count differs from the plain version's")
        kills += ctx.dedup_kills - plain_counted
    if kills == 0:
        raise AssertionError("the dedups of the h2-k2 search killed no row")
    by_rows = sorted(range(len(queues)), key=lambda i: queues[i][1][2].shape[0])
    flush_buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    flush = lambda: flush_buf.fill_(1)  # noqa: E731
    cases = [dict(case=label, dedup=i, **dedup_case(*queues[i], flush, f"{label} queue, dedup {i}"))
             for label, i in (("median", by_rows[len(by_rows) // 2]), ("largest", by_rows[-1]))]
    a = cases[0]
    print(f"workq_dedup: kernels = plain on all {len(queues)} dedups of chunk 0 ({kills} rows killed)", flush=True)
    return dict(
        name="workq_dedup", route="cuda", source="sahara_tpu_torch/kernels/csrc/workq.cu",
        replaces="sahara_tpu/engine/workq.py:771", max_abs_err=0, ms=a["ms"], cold_ms=a["cold_ms"],
        call_ms=a["call_ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"], bound_by=a["bound_by"],
        library_ms=None, cases=cases, dedups=len(queues), kills=kills, queue_rows=[q[2].shape[0] for _, q in queues],
        shape=f"the median of chunk 0's {len(queues)} dedup queues ({DEDUP_GENERATOR}, {qd.shape[0]} strand "
              f"queries): {a['rows']} rows, {a['live']} live",
    )


def count_syncs(run) -> int:
    """Synchronising calls one run makes, as torch.cuda's sync debug mode
    flags them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def timed_passes(run, want: np.ndarray, label: str) -> list[float]:
    """Seconds of three passes, each checked against ``want``."""
    passes = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
        if not np.array_equal(sorted_rows(res), want):
            raise AssertionError(f"a timed {label} pass gave another hit set")
    return passes


def require_launches(launches: dict, names, path: str) -> None:
    for name in names:
        if launches.get(name, 0) == 0:
            raise AssertionError(f"the {path} path never launched {name}")


def hamming_phase(index, ref: np.ndarray, queries: np.ndarray) -> dict:
    """Hamming seed-and-verify on the first reads: every hit's mismatch
    count, recounted on the host, must equal its error count."""
    from sahara_tpu_torch.engine.driver import search_queries
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches

    sub = queries[: 2 * SAMPLED_READS]
    reset_launches()
    res = search_queries(index, sub, k=K, edit=False, chunk=CHUNK)
    launches = LAUNCHES["verify"]
    require_launches(LAUNCHES, ("verify",), "Hamming")
    m = sub.shape[1]
    window = ref[res.pos[:, None] + np.arange(m)]
    mism = (window != sub[res.query_id]).sum(axis=1)
    # a read carries two planted edits; it has Hamming hits when both are
    # substitutions (one in nine) or an indel sits near an end
    if len(res.pos) < SAMPLED_READS // 10 or (res.seq_id != 0).any() or not np.array_equal(mism, res.errors):
        raise AssertionError("Hamming hits disagree with their recounted mismatches")
    return dict(hits=len(res.pos), verify_launches=launches)


def workq_path(host, queries: np.ndarray, sv_rows: np.ndarray):
    """The work-queue engine over the whole workload, both tables on the
    card; its hit set must equal the seed-and-verify path's."""
    from sahara_tpu_torch.engine.device import DeviceIndex
    from sahara_tpu_torch.engine.driver import search_queries
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches

    kw = dict(k=K, edit=True, chunk=CHUNK, engine="workq", generator_name=WORKQ_GENERATOR)
    reset_launches()
    t0 = time.perf_counter()
    index = DeviceIndex.from_host(host)
    torch.cuda.synchronize()
    out = dict(upload_s=time.perf_counter() - t0, rev_rows=index.rev_rows, occ_bytes=index.occ.numel() * 4)
    t0 = time.perf_counter()
    res = search_queries(index, queries, **kw)
    torch.cuda.synchronize()
    out["first_pass_s"] = time.perf_counter() - t0
    out["launches"] = dict(LAUNCHES)
    require_launches(out["launches"], ("workq_step", "workq_dedup"), "work-queue")
    rows = sorted_rows(res)
    out.update(hits=len(rows), sha256=hashlib.sha256(rows.tobytes()).hexdigest())
    print(f"workq hits {len(rows)} sha256 {out['sha256']} (first pass {out['first_pass_s']:.2f} s)", flush=True)
    if not np.array_equal(rows, sv_rows):
        a, b = {tuple(r) for r in rows.tolist()}, {tuple(r) for r in sv_rows.tolist()}
        print("only workq:", sorted(a - b)[:10], "only sv:", sorted(b - a)[:10], flush=True)
        raise AssertionError("work-queue hit set differs from the seed-and-verify hit set")

    run = lambda: search_queries(index, queries, **kw)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    passes = timed_passes(run, rows, "work-queue")
    dt = sorted(passes)[1]
    out.update(passes_s=passes, pass_s=dt, reads_per_s=len(queries) / 2 / dt,
               max_memory_allocated=torch.cuda.max_memory_allocated(), syncs_per_pass=count_syncs(run))
    print(f"workq path: {out['reads_per_s']:.1f} reads/s (median of 3: {dt * 1e3:.1f} ms), "
          f"{out['syncs_per_pass']} syncs a pass, max_memory_allocated {out['max_memory_allocated']} B", flush=True)
    return index, out


def fallback_phase(index, queries: np.ndarray, sv_rows: np.ndarray) -> tuple[dict, np.ndarray, np.ndarray]:
    """An N in a seed part of every 8th read sends it from seed-and-verify
    to the work-queue engine: ``auto`` must equal ``workq`` on all reads,
    and the seed-and-verify rows on the reads without N.  Returns the
    report, the strand queries and their ``auto`` rows."""
    from sahara_tpu_torch.alphabet import D_DNA5
    from sahara_tpu_torch.engine.driver import search_queries
    from sahara_tpu_torch.engine.seedverify import plan_parts
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches

    sub = queries[: 2 * FALLBACK_READS].copy()
    off, ln = plan_parts(sub.shape[1], K)[0]
    for i in range(0, FALLBACK_READS, 8):
        fwd = sub[2 * i].copy()
        fwd[off + ln - 1] = 5  # the last char of the first part: the seed table reads it
        sub[2 * i], sub[2 * i + 1] = fwd, D_DNA5.reverse_complement_rank(fwd)
    reset_launches()
    auto = sorted_rows(search_queries(index, sub, k=K, edit=True, chunk=CHUNK))
    launches = dict(LAUNCHES)
    require_launches(launches, ("seed_scan", "seed_bad_mask", "verify", "workq_step"), "fallback")
    wq = sorted_rows(search_queries(index, sub, k=K, edit=True, chunk=CHUNK, engine="workq"))
    if not np.array_equal(auto, wq):
        raise AssertionError("auto with fallback differs from the work-queue engine")
    clean = np.flatnonzero(~(sub == 5).any(axis=1))
    want = sv_rows[np.isin(sv_rows[:, 0], clean)]
    if not np.array_equal(auto[np.isin(auto[:, 0], clean)], want):
        raise AssertionError("reads without N differ from the seed-and-verify rows")
    out = dict(reads=FALLBACK_READS, n_queries=int(len(sub) - len(clean)), hits=len(auto), launches=launches)
    print(f"fallback: {out['n_queries']} strand queries with N, {len(auto)} hits, auto == workq, "
          f"clean reads == seed-and-verify", flush=True)
    return out, sub, auto


@contextlib.contextmanager
def recorded(module, name: str, size=None):
    """``module.name`` wrapped for the block; yields the list that gets each
    call's (positional arguments, keyword arguments, result), or with
    ``size`` only the call of the largest ``size(args, kw)``."""
    fn, calls = getattr(module, name), []

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        if size is None:
            calls.append((args, kw, out))
        elif not calls or size(args, kw) > size(*calls[0][:2]):
            calls[:] = [(args, kw, out)]
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def rows_sha(rows: np.ndarray) -> str:
    return hashlib.sha256(rows.tobytes()).hexdigest()


def sv_e1_phase(index, ref: np.ndarray) -> dict:
    """The short-read workload (36 bp, k=3) through ``auto``, which takes
    one-error seed-and-verify: its hit set against the JAX package's, three
    timed passes after the first, a profiled pass, its syncs, peak memory and
    the share of queries that fell back to the work-queue engine; then the
    work-queue engine on the first reads against the JAX package's rows for
    it and against seed-and-verify's, which hold every position it finds;
    then the same reads
    under Hamming distance, each hit's mismatches recounted on the host, and
    K3h timed on that run's largest verify call.  K5 (its largest seed-search
    step) and K3 (its largest verify call) are held against their plain
    versions on the edit run's own inputs."""
    from sahara_tpu_torch.engine import driver, seedverify, workq
    from sahara_tpu_torch.engine.driver import search_queries
    from sahara_tpu_torch.engine.seedverify import plan_parts
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches
    from sahara_tpu_torch.kernels.verify import verify, verify_plain
    from sahara_tpu_torch.sim.workload import short_reads

    queries = short_reads(ref)
    n_reads, m = len(queries) // 2, queries.shape[1]
    kw = dict(k=E1_K, edit=True, chunk=CHUNK, generator_name=WORKQ_GENERATOR)
    run = lambda: search_queries(index, queries, **kw)  # noqa: E731
    reset_launches()
    queue = lambda args, kw: args[1][2].shape[0]  # noqa: E731
    drain_queue = lambda args, kw: queue(args, kw) if kw.get("drain") else -1  # noqa: E731
    with (recorded(driver, "_run_sv_chunks") as plans, recorded(seedverify, "verify") as edit_calls,
          recorded(workq, "expand_step", size=queue) as largest,
          recorded(workq, "expand_step", size=drain_queue) as drains):
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    require_launches(launches, ("workq_step", "verify"), "one-error seed-and-verify")
    # exact parts would be found by seed_scan; one-error parts are searched by K5
    if plan_parts(m, E1_K) is not None or len(plans) != 1 or launches.get("seed_scan", 0):
        raise AssertionError("the short reads did not take the one-error seed-and-verify plan")
    fallback = int(plans[0][2][1].sum())
    rows = sorted_rows(res)
    out = dict(reads=n_reads, m=m, k=E1_K, hits=len(rows), sha256=rows_sha(rows), launches=launches,
               first_pass_s=first_s, fallback_queries=fallback, fallback_share=fallback / len(queries))
    print(f"sv_e1: hits {len(rows)} (JAX package {JAX_E1_HITS}) sha256 {out['sha256']}", flush=True)
    if len(rows) != JAX_E1_HITS or out["sha256"] != JAX_E1_SHA256:
        raise AssertionError("one-error seed-and-verify hit set differs from the JAX package's")
    prefix = rows[rows[:, 0] < 2 * E1_PREFIX_READS]
    if len(prefix) != JAX_E1_PREFIX_HITS or rows_sha(prefix) != JAX_E1_PREFIX_SHA256:
        raise AssertionError("the first reads' hit set differs from the JAX package's")

    # K5 and K3 (edit) on this run's inputs: its seed search's largest step
    # and largest drain step (k=1 tape, dedup on), its largest verify call
    if not drains[0][1].get("drain"):
        raise AssertionError("the one-error seed search made no drain step")
    cases = [step_case(*call[0], call[1].get("drain", False), f"sv_e1 seed search, {what}")
             for call, what in ((largest[0], "largest queue"), (drains[0], "largest drain step"))]
    out["workq_step"] = dict(cases[0], max_abs_err=sum(c["max_abs_err"] for c in cases), cases=cases)
    vargs = max((args for args, _, _ in edit_calls), key=lambda a: a[3].shape[0])
    b, by = edit_bound(vargs)
    call = lambda: verify(*vargs)  # noqa: E731
    out["verify"] = dict(
        max_abs_err=assert_equal("verify (sv_e1)", call(), verify_plain(*vargs)),
        ms=kernel_device_ms(call, "edit_kernel", 20), call_ms=time_ms(call, 20),
        plain_ms=time_ms(lambda: verify_plain(*vargs), 2), bound_ms=b, bound_by=by,
        candidates=sum(args[3].shape[0] for args, _, _ in edit_calls),
        shape=f"{vargs[3].shape[0]} candidates x {2 * E1_K + 1} starts, m={m}, k={E1_K}",
    )
    print(f"verify (sv_e1, {out['verify']['shape']}): equal to plain, device {out['verify']['ms']:.4f} ms, call "
          f"{out['verify']['call_ms']:.4f} ms, plain {out['verify']['plain_ms']:.3f} ms, bound {b:.5f} ms by {by}",
          flush=True)
    del largest, drains, edit_calls, vargs, call  # the recorded inputs would count in the passes' peak memory

    torch.cuda.reset_peak_memory_stats()
    passes = timed_passes(run, rows, "one-error seed-and-verify")
    dt = sorted(passes)[1]
    out.update(passes_s=passes, pass_s=dt, reads_per_s=n_reads / dt,
               max_memory_allocated=torch.cuda.max_memory_allocated(), syncs_per_pass=count_syncs(run),
               profile=profile_pass(run))
    busy = out["profile"]["device_busy_ms"]
    print(f"sv_e1 path: {out['reads_per_s']:.1f} reads/s (median of 3: {dt * 1e3:.1f} ms for {n_reads} reads, "
          f"both strands; first pass {first_s:.2f} s), device busy {busy:.1f} ms ({busy / (dt * 1e3) * 100:.1f}%), "
          f"{out['syncs_per_pass']} syncs a pass, max_memory_allocated {out['max_memory_allocated']} B, "
          f"{fallback} of {len(queries)} strand queries fell back ({out['fallback_share'] * 100:.3f}%)", flush=True)

    # the work-queue engine on the first reads: the JAX package's rows for
    # that engine, every one of them a seed-and-verify position at no fewer
    # errors (seed-and-verify finds a superset, see JAX_E1_WORKQ_PREFIX_HITS)
    sub = queries[: 2 * E1_PREFIX_READS]
    wq_run = lambda: search_queries(index, sub, engine="workq", **kw)  # noqa: E731
    wq_rows = sorted_rows(wq_run())
    sv_err = {(q, p): e for q, _, p, e in prefix.tolist()}
    only_sv = {tuple(r) for r in prefix.tolist()} - {tuple(r) for r in wq_rows.tolist()}
    print(f"sv_e1 vs workq on the first {E1_PREFIX_READS} reads: workq {len(wq_rows)} hits (JAX package's workq "
          f"{JAX_E1_WORKQ_PREFIX_HITS}), sv_e1 {len(prefix)}; rows only sv_e1 gives: {sorted(only_sv)}", flush=True)
    if len(wq_rows) != JAX_E1_WORKQ_PREFIX_HITS or rows_sha(wq_rows) != JAX_E1_WORKQ_PREFIX_SHA256:
        raise AssertionError("the short-read work-queue hit set differs from the JAX package's")
    if any(sv_err.get((q, p), e + 1) > e for q, _, p, e in wq_rows.tolist()):
        raise AssertionError("the work-queue engine found a hit that one-error seed-and-verify did not")
    wq_passes = timed_passes(wq_run, wq_rows, "short-read work-queue")
    sv_passes = timed_passes(lambda: search_queries(index, sub, **kw), prefix, "short-read seed-and-verify")
    out["workq_prefix"] = dict(
        reads=E1_PREFIX_READS, hits=len(wq_rows), sv_hits=len(prefix), rows_only_sv=sorted(only_sv),
        workq_passes_s=wq_passes, sv_passes_s=sv_passes, workq_reads_per_s=E1_PREFIX_READS / sorted(wq_passes)[1],
        sv_reads_per_s=E1_PREFIX_READS / sorted(sv_passes)[1],
    )
    print(f"  seed-and-verify {out['workq_prefix']['sv_reads_per_s']:.1f} reads/s, work-queue "
          f"{out['workq_prefix']['workq_reads_per_s']:.1f} reads/s (medians of 3)", flush=True)

    # Hamming: every hit's mismatches recounted; K3h on the largest verify call
    reset_launches()
    with recorded(seedverify, "verify") as calls:
        ham = search_queries(index, queries, **{**kw, "edit": False})
    ham_launches = dict(LAUNCHES)
    require_launches(ham_launches, ("workq_step", "verify"), "one-error Hamming")
    ham_rows = sorted_rows(ham)
    window = ref[ham.pos[:, None] + np.arange(m)]
    if (ham.seq_id != 0).any() or not np.array_equal((window != queries[ham.query_id]).sum(axis=1), ham.errors):
        raise AssertionError("one-error Hamming hits disagree with their recounted mismatches")
    if len(ham_rows) != JAX_E1_HAMMING_HITS or rows_sha(ham_rows) != JAX_E1_HAMMING_SHA256:
        raise AssertionError("one-error Hamming hit set differs from the JAX package's")
    flush_buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=index.device)
    largest = max((args for args, _, _ in calls), key=lambda a: a[3].shape[0])
    out["hamming"] = dict(
        hits=len(ham_rows), sha256=rows_sha(ham_rows), launches=ham_launches, verify_launches=ham_launches["verify"],
        candidates=sum(args[3].shape[0] for args, _, _ in calls),
        k3h=hamming_times(largest, lambda: flush_buf.fill_(1)),
    )
    print(f"sv_e1 Hamming: {len(ham_rows)} hits (JAX package {JAX_E1_HAMMING_HITS}, same sha256), mismatches "
          f"recounted; K3h {ham_launches['verify']} launches over {out['hamming']['candidates']} candidates", flush=True)
    return out


def run_cli(argv: list[str]) -> tuple[float, str]:
    """One subcommand of the port's CLI, in this process (so that its
    launches count): its wall seconds and its standard output."""
    from sahara_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{' '.join(argv[:1])} exited {rc}: {buf.getvalue()[-2000:]}")
    return wall, buf.getvalue()


def stats_block(log: str) -> dict:
    """The seconds of each phase of a subcommand's ``stats:`` block."""
    return {m.group(1): float(m.group(2)) for m in re.finditer(r"^  (.+?) time: +([\d.]+)s$", log, re.M)}


def cli_index_phase(tmp: str, ref: np.ndarray, queries: np.ndarray) -> tuple[dict, str, str]:
    """The ``bench.py`` workload's files through the CLI: the reference as a
    one-record FASTA, ``read_simulator`` (its reads must be the workload's
    forward reads) and ``index`` (the bidirectional index with its full-SA
    sidecar, which the other phases load)."""
    from sahara_tpu_torch.alphabet import D_DNA5
    from sahara_tpu_torch.io.fasta import FastaRecord, read_fasta_seq_matrix, write_fasta

    fasta, reads = os.path.join(tmp, "ref.fasta"), os.path.join(tmp, "reads.fasta")
    write_fasta(fasta, [FastaRecord("ref", D_DNA5.rank_to_char(ref))], line_length=0)
    n_reads, m = len(queries) // 2, queries.shape[1]
    sim_s, _ = run_cli(["read_simulator", "-i", fasta, "-o", reads, "-n", str(n_reads), "-l", str(m), "-e", str(K),
                        "--seed", "99", "--fasta_line_length", "0"])
    mat = read_fasta_seq_matrix(reads)
    if mat is None or not np.array_equal(D_DNA5.char_to_rank_table[mat], queries[0::2]):
        raise AssertionError("read_simulator's reads differ from the bench.py workload's")
    index_s, log = run_cli(["index", fasta])
    out = dict(read_simulator_s=sim_s, index_s=index_s, index_stats=stats_block(log))
    print(f"cli: read_simulator {sim_s:.1f} s ({n_reads} reads equal the workload's), index {index_s:.1f} s "
          f"(stats {json.dumps(out['index_stats'])})", flush=True)
    return out, fasta, reads


def cli_search_phase(tmp: str, fasta: str, reads: str, n_reads: int, sv_rows: np.ndarray, card: str) -> dict:
    """``search`` of the workload's reads through the CLI on the card:
    buffered, then streamed (``SAHARA_STREAM=1``), both files byte-equal to
    the JAX package's CLI output and to the seed-and-verify path's rows."""
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches

    outs = [os.path.join(tmp, "out.txt"), os.path.join(tmp, "out_stream.txt")]
    argv = ["search", "-q", reads, "-i", fasta + ".idx", "-e", str(K), "-d", "lev"]
    reset_launches()
    wall, log = run_cli(argv + ["-o", outs[0]])
    launches = dict(LAUNCHES)
    require_launches(launches, ("rank_all", "seed_scan", "verify"), "CLI search")
    with open(outs[0], "rb") as fh:
        data = fh.read()
    sha, lines = hashlib.sha256(data).hexdigest(), data.count(b"\n")
    print(f"cli search: {lines} lines, sha256 {sha} (JAX package's CLI: {JAX_CLI_LINES}, {JAX_CLI_SHA256})",
          flush=True)
    if sha != JAX_CLI_SHA256 or lines != JAX_CLI_LINES:
        raise AssertionError("the CLI's output differs from the JAX package's CLI output")
    got = np.array(data.decode().split(), dtype=np.int64).reshape(-1, 3)
    if not np.array_equal(got[np.lexsort(got.T[::-1])], sv_rows[:, :3]):
        raise AssertionError("the CLI's hits differ from the seed-and-verify path's rows")
    os.environ["SAHARA_STREAM"] = "1"
    try:
        stream_wall, stream_log = run_cli(argv + ["-o", outs[1]])
    finally:
        del os.environ["SAHARA_STREAM"]
    with open(outs[1], "rb") as fh:
        if "streaming:           True" not in stream_log or fh.read() != data:
            raise AssertionError("the streamed search is not byte-identical to the buffered one")
    out = dict(wall_s=wall, reads_per_s=n_reads / wall, stats=stats_block(log), launches=launches,
               stream_wall_s=stream_wall, stream_reads_per_s=n_reads / stream_wall,
               stream_stats=stats_block(stream_log), lines=lines, sha256=sha, card=card)
    for label, key in (("buffered", ""), ("streamed", "stream_")):
        print(f"cli search {label}: wall {out[key + 'wall_s']:.2f} s, {out[key + 'reads_per_s']:.1f} reads/s end to "
              f"end ({n_reads} reads, both strands); stats block s {json.dumps(out[key + 'stats'])}; {card}",
              flush=True)
    print(f"cli search launches: {json.dumps(launches)}; streamed output byte-identical", flush=True)
    return out


def cli_golden_phase(tmp: str) -> dict:
    """The conformance corpus through the port's ``read_simulator`` and
    index subcommands, the 9 ``search`` and 2 ``rbi`` cases on the card,
    each byte-equal to its golden; r2 through ``--engine workq`` on the
    card and on the CPU, byte-equal."""
    from sahara_tpu_torch.io.fasta import FastaRecord, write_fasta
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches

    gdir = os.path.join(tmp, "goldens")
    os.makedirs(gdir)
    rng = np.random.default_rng(GOLDEN_SEED)
    ref = os.path.join(gdir, "ref.fasta")
    write_fasta(ref, [FastaRecord(id=f"chr{i}", seq=bytes(b"ACGT"[j] for j in rng.integers(0, 4, size=n)))
                      for i, n in enumerate(GOLDEN_SEQ_LENS)])
    for name, (n, m, e, seed) in GOLDEN_READS.items():
        run_cli(["read_simulator", "-i", ref, "-o", os.path.join(gdir, f"{name}.fasta"), "-n", str(n), "-l", str(m),
                 "-e", str(e), "--seed", str(seed)])
    for cmd in ("index", "rbi-index", "rbi-index-dna4"):
        run_cli([cmd, ref])
    runs = [(name, ["search", "-q", os.path.join(gdir, f"{reads}.fasta"), "-i", ref + ".idx"] + flags)
            for name, reads, flags in GOLDEN_CASES]
    runs += [(name, [cmd, "-q", os.path.join(gdir, "r1.fasta"), "-i", ref + suffix, "-e", "1", "-g", "optimum"])
             for name, cmd, suffix in GOLDEN_RBI_CASES]
    reset_launches()
    for name, argv in runs:
        out = os.path.join(gdir, name)
        run_cli(argv + ["-o", out, "--device", "cuda"])
        with open(out) as a, open(os.path.join(GOLDEN_DIR, name)) as b:
            if a.read() != b.read():
                raise AssertionError(f"{name} on the card differs from its golden")
    launches = dict(LAUNCHES)
    require_launches(launches, ("rank_all", "seed_scan", "verify"), "goldens")
    reset_launches()
    workq = {}
    for device in ("cuda", "cpu"):
        workq[device] = os.path.join(gdir, f"r2_workq_{device}.txt")
        run_cli(["search", "-q", os.path.join(gdir, "r2.fasta"), "-i", ref + ".idx", "-o", workq[device], "-e", "2",
                 "-d", "lev", "-g", "optimum", "--engine", "workq", "--device", device])
    workq_launches = dict(LAUNCHES)
    require_launches(workq_launches, ("workq_step",), "CLI work-queue")
    with open(workq["cuda"]) as a, open(workq["cpu"]) as b:
        text = a.read()
        if text != b.read() or not text:
            raise AssertionError("--engine workq on the card differs from the CPU")
    out = dict(cases=[name for name, _ in runs], launches=launches, workq_launches=workq_launches,
               workq_lines=text.count("\n"))
    print(f"cli goldens: {len(runs)} byte-identical on the card (launches {json.dumps(launches)}); r2 --engine workq "
          f"card == CPU ({out['workq_lines']} lines, {workq_launches['workq_step']} workq_step launches)", flush=True)
    return out


def exact_words(args, skip: torch.Tensor) -> tuple[int, int, int, int]:
    """(distinct (occ row, symbol) words K6 ranks at, rank steps, distinct
    32 B sectors of those words) of the plain full scan on
    ``exact_search``'s arguments, whatever the kernel starts from, and the
    occ words the kernel loads, skipping each query's first ``skip`` steps
    (two a step, four where the ends lie in two rows): the interval before
    each step gives the rows that step reads."""
    from sahara_tpu_torch.engine.rank import rank_sym

    occ, c_arr, queries, qlens, sigma, n = args[:6]
    q = queries.long()
    lens = qlens.long().clamp(0, q.shape[1])
    lb = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    rb = torch.full_like(lb, n)
    keys, loads = [], 0
    for j in range(q.shape[1]):
        at = lens - 1 - j
        act = at >= 0
        c = q.gather(1, at.clamp(min=0)[:, None])[:, 0].clamp(max=sigma - 1)
        keys += [((lb.long() >> 5) * sigma + c)[act], ((rb.long() >> 5) * sigma + c)[act]]
        loads += int((2 + 2 * ((lb >> 5) != (rb >> 5)).long())[act & (j >= skip)].sum())
        base = c_arr[c]
        lb = torch.where(act, base + rank_sym(occ, sigma, c, lb), lb)
        rb = torch.where(act, base + rank_sym(occ, sigma, c, rb), rb)
    keys = torch.unique(torch.cat(keys))
    return keys.numel(), int(lens.sum()), occ_sectors(keys, occ.shape[1], sigma), loads


def occ_sectors(keys: torch.Tensor, row_ints: int, sigma: int) -> int:
    """Distinct 32 B sectors of the checkpoints and bit words of the (occ
    row, symbol) ``keys`` (row * sigma + symbol)."""
    row, c = keys // sigma * row_ints, keys % sigma
    return torch.unique(torch.cat([(row + c) >> 3, (row + sigma + c) >> 3])).numel()


def sector_ms(sectors: int) -> float:
    """A random-gather floor: ``sectors`` 32 B sectors over the HBM rate."""
    return sectors * 32 / PEAK_BYTES_S * 1e3


def exact_figures(args, flush) -> dict:
    """K6 on one recorded call's arguments (``exact_search``'s, with the
    j-mer table where the path passed it): held against its plain full scan,
    also without the table; device times warm and cold beside those without
    the table (the warm time taken again last, the spread of one
    configuration in the run), call time, the plain version's time and the bound.  Where the call has the
    table, K6 also runs with a table of empty intervals: a query it starts
    from the table then finds nothing, so the queries whose hit vanishes are
    the ones the kernel started there (``table_start_k6``), held against
    the rule (``table_start``) on every query with a hit.  ``model``: what
    the plain scan's run implies, not measured (longest chain, steps run,
    distinct 32 B sectors and their time at the HBM rate, occ loads the
    design issues)."""
    from sahara_tpu_torch.kernels.exact import exact_search, exact_search_plain, table_start

    occ, _, queries, qlens, sigma, n = args[:6]
    want = exact_search_plain(*args[:6])
    err = assert_equal("exact_search", exact_search(*args), want)
    lens = qlens.long().clamp(0, queries.shape[1])
    lut, lut_j = args[6:8] if len(args) > 6 else (None, 0)
    _, _, skip = table_start(queries.long(), lens, lut, lut_j, sigma, n)
    words, steps, sectors, loads = exact_words(args, skip)
    # each (row, symbol) checkpoint and bit word, query char, length and
    # output once; a step ranks both ends: shift, and and popc each on the
    # ALU with the symbol's clamp and the row compare, and six adds (masks,
    # checkpoints, bases)
    b, by = bound(words * 8 + steps + queries.shape[0] * 12, steps * 8, steps * 6)
    call = lambda: exact_search(*args)  # noqa: E731
    times = kernel_times(call, "exact_kernel", flush)
    started = {}
    if lut is not None:
        scan = lambda: exact_search(*args[:6])  # noqa: E731
        assert_equal("exact_search without the j-mer table", scan(), want)
        started.update(no_table_ms=kernel_device_ms(scan, "exact_kernel", 20),
                       no_table_cold_ms=kernel_device_ms(scan, "exact_kernel", 20, before=flush))
        empty = (*args[:6], torch.zeros_like(lut), lut_j)
        got = exact_search(*empty)
        assert_equal("exact_search with a table of empty intervals", got, exact_search_plain(*empty))
        hit = want[1] > 0
        took = hit & (got[1] == 0)
        if not torch.equal(took, hit & (skip > 0)):
            raise AssertionError(f"K6 started {int(took.sum())} queries with a hit from the j-mer table, the rule "
                                 f"{int((hit & (skip > 0)).sum())}")
        started.update(table_start_k6=int(took.sum()), queries_with_hit=int(hit.sum()))
    return dict(
        max_abs_err=err, **times, ms_again=kernel_device_ms(call, "exact_kernel", 20), **started,
        plain_ms=time_ms(lambda: exact_search_plain(*args), 2), bound_ms=b, bound_by=by, occ_words=words,
        steps=steps, rows_found=int(want[1].sum()),
        model=dict(table_start_rule=int((skip > 0).sum()), longest_chain=int((lens - skip).max()),
                   steps_run=int((lens - skip).sum()), sectors=sectors, sector_ms=sector_ms(sectors),
                   occ_loads=loads, occ_loads_per_s=loads / times["ms"] * 1e3),
        shape=f"{queries.shape[0]} queries x {queries.shape[1]} symbols, sigma={sigma}, {occ.shape[1]}-int rows",
    )


def walk_words(args) -> dict:
    """Distinct sampled words, (occ row, symbol) words and sample slots of
    the sampled walk on ``lf_walk``'s arguments, its LF steps, bit planes
    tested, longest walk and distinct 32 B sectors, from the plain walk."""
    from sahara_tpu_torch.engine.rank import lf, occ_row, sampled_bit, sampled_rank, symbol_from_row

    occ, c_arr, sampled, sample_seq, _, sigma, rate, rows = args
    live = torch.ones_like(rows, dtype=torch.bool)
    walked = torch.zeros_like(rows)
    s_keys, o_keys, planes = [rows.long() >> 5], [], 0
    for _ in range(rate):
        live &= sampled_bit(sampled, rows) == 0
        c = symbol_from_row(occ_row(occ, rows), sigma, rows)
        o_keys.append(((rows.long() >> 5) * sigma + c)[live])
        walked += live
        planes += int((c + 1)[live].sum())
        rows = torch.where(live, lf(occ, c_arr, sigma, rows), rows)
        s_keys.append((rows.long() >> 5)[live])
    slots = torch.unique(sampled_rank(sampled, rows).clamp(0, sample_seq.shape[0] - 1))
    s_words, o_words = torch.unique(torch.cat(s_keys)), torch.unique(torch.cat(o_keys))
    # sampled words are 8 B, sample_seq and sample_pos entries 4 B each
    sectors = (torch.unique(s_words >> 2).numel() + occ_sectors(o_words, occ.shape[1], sigma)
               + 2 * torch.unique(slots >> 3).numel())
    return dict(sampled_words=s_words.numel(), occ_words=o_words.numel(), slots=slots.numel(),
                lf_steps=int(walked.sum()), planes=planes,
                model=dict(longest_chain=int(walked.max()), sectors=sectors, sector_ms=sector_ms(sectors)))


def walk_figures(args, flush) -> dict:
    """K7 on one recorded call's arguments (``lf_walk``'s): held against its
    plain version; device times warm and cold (the warm time taken again
    last), call time, the plain version's time and the bound; ``model``:
    the longest walk and the distinct 32 B sectors of the plain walk."""
    from sahara_tpu_torch.kernels.lf_walk import lf_walk, lf_walk_plain

    occ, sigma, rate, rows = args[0], args[5], args[6], args[7]
    want = lf_walk_plain(*args)
    err = assert_equal("lf_walk", lf_walk(*args), want)
    w = walk_words(args)
    # each sampled word, (row, symbol) checkpoint and bit word and sample
    # slot once, each row in and (seq_id, pos) out once; a step tests its
    # sampled bit and each plane up to the symbol's (shift and and), masks
    # and counts; four adds (mask, rank, base, steps)
    b, by = bound(8 * (w["sampled_words"] + w["occ_words"] + w["slots"]) + 12 * rows.shape[0],
                  w["lf_steps"] * 5 + w["planes"] * 2, w["lf_steps"] * 4)
    call = lambda: lf_walk(*args)  # noqa: E731
    return dict(
        max_abs_err=err, **kernel_times(call, "lf_walk_kernel", flush),
        ms_again=kernel_device_ms(call, "lf_walk_kernel", 20),
        plain_ms=time_ms(lambda: lf_walk_plain(*args), 2), bound_ms=b, bound_by=by, **w,
        shape=f"{rows.shape[0]} rows, sigma={sigma}, {occ.shape[1]}-int rows, rate {rate}",
    )


def search_output(path: str, want_sha: str, want_lines: int, what: str) -> tuple[np.ndarray, str, int]:
    """A search's output file as int64 rows [N, 3], its sha256 and lines;
    raises unless they are the JAX package's CLI output's."""
    with open(path, "rb") as fh:
        data = fh.read()
    sha, lines = hashlib.sha256(data).hexdigest(), data.count(b"\n")
    print(f"{what}: {lines} lines, sha256 {sha} (JAX package's CLI: {want_lines}, {want_sha})", flush=True)
    if sha != want_sha or lines != want_lines:
        raise AssertionError(f"the {what} output differs from the JAX package's CLI output")
    return np.array(data.decode().split(), dtype=np.int64).reshape(-1, 3), sha, lines


def uni_phase(tmp: str, fasta: str, card: str) -> tuple[dict, dict, dict]:
    """Phase uni: EXACT_READS error-free reads through ``read_simulator``,
    ``uni-index`` and ``uni-search`` on the card; the output's sha256
    against the JAX package's CLI, K6 launched there, with the j-mer table,
    and K1 by the upload (the table); the same strand queries through
    ``exact_search`` and ``locate`` on an upload without the full suffix
    array (the sampled walk, K7 at sigma 6) give the same rows.  Returns the
    phase's report (with the queries K6 started from the table and the
    plain runs' longest chains), K6's figures on the uni-search call and
    K7's on the sampled locate."""
    from sahara_tpu_torch.alphabet import D_DNA5
    from sahara_tpu_torch.cli.common import load_queries_ranked
    from sahara_tpu_torch.engine.device import DeviceIndex, pad_queries
    from sahara_tpu_torch.engine.exact import exact_search
    from sahara_tpu_torch.engine.locate import locate
    from sahara_tpu_torch.index.fmindex import load_index
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches
    from sahara_tpu_torch.kernels import exact as k6
    from sahara_tpu_torch.kernels import lf_walk as k7

    reads, out = os.path.join(tmp, "exact_reads.fasta"), os.path.join(tmp, "uni_out.txt")
    sim_s, _ = run_cli(["read_simulator", "-i", fasta, "-o", reads, "-n", str(EXACT_READS), "-l", "100", "-e", "0",
                        "--seed", "99", "--fasta_line_length", "0"])
    index_s, index_log = run_cli(["uni-index", fasta])
    reset_launches()
    with recorded(k6, "exact_search") as calls:
        wall, log = run_cli(["uni-search", "-q", reads, "-i", fasta + ".single.idx", "-o", out])
    launches = dict(LAUNCHES)
    require_launches(launches, ("exact_search", "rank_all"), "uni-search")
    rows, sha, lines = search_output(out, JAX_UNI_SHA256, JAX_UNI_LINES, "uni-search")

    sampled = DeviceIndex.from_host(load_index(fasta + ".single.idx"), full_sa=False)
    queries = load_queries_ranked(reads, D_DNA5, add_revcomp=True)
    reset_launches()
    with recorded(k7, "lf_walk") as walks:
        got = np.stack([t.cpu().numpy() for t in locate(sampled, *exact_search(sampled, *pad_queries(queries)))], 1)
    sampled_launches = dict(LAUNCHES)
    require_launches(sampled_launches, ("exact_search", "lf_walk"), "sampled locate")
    if not np.array_equal(got, rows):
        raise AssertionError("exact search with the sampled walk gives other rows than uni-search")
    flush_buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=sampled.device)
    flush = lambda: flush_buf.fill_(1)  # noqa: E731
    k6_fig, k7_fig = exact_figures(calls[0][0], flush), walk_figures(walks[0][0], flush)
    if not k6_fig["table_start_k6"] > 0:
        raise AssertionError("K6 started no query of uni-search from the j-mer table")
    rep = dict(reads=EXACT_READS, queries=len(queries), read_simulator_s=sim_s, index_s=index_s,
               index_stats=stats_block(index_log), wall_s=wall, reads_per_s=EXACT_READS / wall,
               stats=stats_block(log), launches=launches, lines=lines, sha256=sha,
               sampled_launches=sampled_launches, k6_table_start=k6_fig["table_start_k6"],
               k6_queries_with_hit=k6_fig["queries_with_hit"], k6_longest_chain=k6_fig["model"]["longest_chain"],
               k7_longest_chain=k7_fig["model"]["longest_chain"], card=card)
    print(f"uni: uni-index {index_s:.1f} s; uni-search wall {wall:.2f} s, {rep['reads_per_s']:.1f} reads/s end to end "
          f"({EXACT_READS} reads, both strands); stats block s {json.dumps(rep['stats'])}; launches "
          f"{json.dumps(launches)}; the sampled walk gives the same {len(rows)} rows ({json.dumps(sampled_launches)}); "
          f"K6 started {rep['k6_table_start']} of the {rep['k6_queries_with_hit']} queries with a hit from the j-mer "
          f"table (the queries whose hit a table of empty intervals takes away, as the rule says); longest chains "
          f"of the plain runs: K6 {rep['k6_longest_chain']}, K7 {rep['k7_longest_chain']} steps; {card}", flush=True)
    return rep, k6_fig, k7_fig


def kmer_phase(tmp: str, fasta: str, reads: str, card: str) -> tuple[dict, dict, dict]:
    """Phase kmer: ``kmer-index`` of the reference (``KMER_FLAGS``: sigma
    32) and ``kmer-search`` of phase uni's reads on the card; the output's
    sha256 against the JAX package's CLI and K6 and K7 launched at sigma 32.
    Returns the phase's report and K6's and K7's figures on that run's
    calls."""
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches
    from sahara_tpu_torch.kernels import exact as k6
    from sahara_tpu_torch.kernels import lf_walk as k7

    out = os.path.join(tmp, "kmer_out.txt")
    index_s, index_log = run_cli(["kmer-index", fasta] + KMER_FLAGS)
    reset_launches()
    with recorded(k6, "exact_search") as calls, recorded(k7, "lf_walk") as walks:
        wall, log = run_cli(["kmer-search", "--query", reads, "--index", fasta + ".kmer.idx", "--output", out])
    launches = dict(LAUNCHES)
    require_launches(launches, ("exact_search", "lf_walk"), "kmer-search")
    _, sha, lines = search_output(out, JAX_KMER_SHA256, JAX_KMER_LINES, "kmer-search")
    sigmas = {calls[0][0][4], walks[0][0][5]}
    if sigmas != {KMER_SIGMA}:
        raise AssertionError(f"kmer-search ran at sigma {sigmas}, not {KMER_SIGMA}")
    flush_buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=calls[0][0][0].device)
    flush = lambda: flush_buf.fill_(1)  # noqa: E731
    k6_fig, k7_fig = exact_figures(calls[0][0], flush), walk_figures(walks[0][0], flush)
    rep = dict(index_s=index_s, index_stats=stats_block(index_log),
               wall_s=wall, reads_per_s=EXACT_READS / wall, stats=stats_block(log), launches=launches, lines=lines,
               sha256=sha, sigma=KMER_SIGMA, card=card)
    print(f"kmer: kmer-index {index_s:.1f} s (stats {json.dumps(rep['index_stats'])}); kmer-search wall {wall:.2f} s, "
          f"{rep['reads_per_s']:.1f} reads/s end to end; stats block s {json.dumps(rep['stats'])}; launches "
          f"{json.dumps(launches)}; {card}", flush=True)
    return rep, k6_fig, k7_fig


def step_figures(ctx, state, out) -> dict:
    """Live slots (sz > 0), ranked slots (live, d < m), the lanes with a
    finished slot (a hit, stored or not), the distinct occ rows the ranks
    read and the children (sz > 0 in ``out``) of one step on ``state`` with
    sz = 0 past the live slots."""
    from sahara_tpu_torch.kernels.frontier import D, EDGES, LB, LBR, OP, SZ

    live = state[SZ] > 0
    ranked = live & (state[D] < ctx.m)
    finished = live & ~ranked & ((state[OP] & EDGES) == 0)
    lane = torch.nonzero(ranked)[:, 0]
    side = ctx.tape[lane % ctx.ns, state[D][ranked]] & 1
    primary = torch.where(side == 1, state[LBR][ranked], state[LB][ranked]).long()
    woff = side.long() * ctx.rev_off
    rows = torch.unique(torch.cat([(primary >> 5) + woff, ((primary + state[SZ][ranked]) >> 5) + woff])).numel()
    return dict(live=int(live.sum()), ranked=int(ranked.sum()), hit_lanes=int(finished.any(dim=1).sum()),
                occ_rows=rows, children=int((out[SZ] > 0).sum()))


def frontier_bound(ctx, fig: dict, new_hits: int, new_flags: int) -> tuple[float, str]:
    """The least work of one K8 step (``step_figures``' counts): each lane's
    live count read and its next one written; the hit count of a lane with
    a finished slot read and written; each live slot's 24 B; a tape word
    and a query char a ranked slot; each distinct occ row once; the
    children's 24 B, the new hits' 12 B and a word a flag newly set."""
    from sahara_tpu_torch.kernels.frontier import n_kinds

    n_bytes = (ctx.lanes * 8 + fig["hit_lanes"] * 8 + fig["live"] * 24 + fig["ranked"] * 5 + fig["occ_rows"] * 64
               + fig["children"] * 24 + new_hits * 12 + new_flags * 4)
    return bound(n_bytes, fig["ranked"] * (6 * ctx.sigma + 4 * n_kinds(ctx.sigma, ctx.edit)))


def approx_phase(index, queries: np.ndarray, sv_rows: np.ndarray, tmp: str, fasta: str, reads: str) -> dict:
    """The frontier engine (``engine="approx"``, K8) over the workload on the
    upload with both tables: the rows of its first APPROX_PREFIX queries
    against the JAX package's, the whole row set beside seed-and-verify's,
    each search (caps, lanes, overflowing lanes), K8 against its plain step
    at every step of the first chunk's first attempt, K8 timed on the widest
    of those steps and in a pass, three timed passes, and the CLI's
    ``--engine approx`` against the JAX CLI's."""
    from sahara_tpu_torch.engine import approx
    from sahara_tpu_torch.engine.driver import load_scheme, search_queries
    from sahara_tpu_torch.engine.tape import compile_tape
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches
    from sahara_tpu_torch.kernels.frontier import SZ, frontier_step, frontier_step_plain, pack_tape

    kw = dict(k=K, edit=True, chunk=CHUNK, engine="approx", generator_name=WORKQ_GENERATOR)
    searches = []
    reset_launches()
    with recorded(approx, "scheme_search") as calls:
        t0 = time.perf_counter()
        res = search_queries(index, queries, **kw)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    require_launches(launches, ("frontier_step",), "approx")
    for args, ckw, (_, _, flags) in calls:
        searches.append(dict(s_cap=ckw["s_cap"], h_cap=ckw["h_cap"], lanes=flags.shape[1],
                             overflow_lanes=int(flags.any(dim=0).sum()), own_caps=ckw["caps"] is not None))
    rows = sorted_rows(res)
    prefix = rows[rows[:, 0] < APPROX_PREFIX]
    n_chunks = -(-len(queries) // CHUNK)
    out = dict(hits=len(rows), sha256=rows_sha(rows), prefix_hits=len(prefix), prefix_sha256=rows_sha(prefix),
               first_pass_s=first_s, launches=launches, searches=searches, retry_searches=len(searches) - n_chunks)
    print(f"approx: {len(rows)} rows; first {APPROX_PREFIX} queries {len(prefix)} rows sha256 {out['prefix_sha256']} "
          f"(JAX package {JAX_APPROX_PREFIX_HITS}, {JAX_APPROX_PREFIX_SHA256}); {len(searches)} searches for "
          f"{n_chunks} chunks, {launches['frontier_step']} K8 launches; searches (s_cap, h_cap, lanes, overflowing "
          f"lanes, caps a query): {[tuple(x.values()) for x in searches]}", flush=True)
    if len(prefix) != JAX_APPROX_PREFIX_HITS or out["prefix_sha256"] != JAX_APPROX_PREFIX_SHA256:
        raise AssertionError("the frontier engine's rows differ from the JAX package's")
    mine, theirs = ({tuple(r) for r in x[:, :3].tolist()} for x in (rows, sv_rows))
    err_of = {tuple(r[:3]): r[3] for r in sv_rows.tolist()}
    out.update(only_approx=len(mine - theirs), only_sv=len(theirs - mine),
               other_errors=sum(err_of[tuple(r[:3])] != r[3] for r in rows.tolist() if tuple(r[:3]) in err_of),
               only_approx_first=sorted(mine - theirs)[:5], only_sv_first=sorted(theirs - mine)[:5])
    print(f"approx against seed-and-verify ({len(sv_rows)} rows): {out['only_approx']} rows only in approx, "
          f"{out['only_sv']} only in seed-and-verify, {out['other_errors']} with another error count; first "
          f"{out['only_approx_first']} / {out['only_sv_first']}", flush=True)

    # K8 against its plain step, every step of the first chunk's first attempt (the widest kept), then every
    # step of a whole pass
    steps, kernel = [], approx.frontier_step

    def check(ctx, state, live, nxt, nxt_live, hits, hit_cnt, flags, **ckw):
        before = (hits.clone(), hit_cnt.clone(), flags.clone())
        want = [torch.empty_like(nxt), torch.empty_like(nxt_live), *(x.clone() for x in before)]
        nxt.fill_(-1)  # no slot or count the kernel leaves unwritten can pass for its own
        nxt_live.fill_(-1)
        kernel(ctx, state, live, nxt, nxt_live, hits, hit_cnt, flags, **ckw)
        frontier_step_plain(ctx, state, live, *want)
        err = assert_equal("frontier_step live counts", nxt_live, want[1])
        prefix = torch.arange(ctx.s_cap, device=nxt.device) < nxt_live[:, None]
        err += assert_equal("frontier_step frontier", torch.where(prefix, nxt, 0), want[0])
        err += sum(assert_equal(f"frontier_step {name}", a, b)
                   for name, a, b in zip(("hits", "hit counts", "flags"), (hits, hit_cnt, flags), want[2:]))
        n_in = int(live.sum())
        if check.capture and (not steps or n_in > steps[0][1]):
            steps[:] = [(check.n, n_in, ctx, state.clone(), live.clone(), before, int(hit_cnt.sum()))]
        check.n += 1
        check.err += err

    check.n = check.err = 0
    check.capture = True
    q0 = np.ascontiguousarray(queries[:CHUNK])
    t = compile_tape(load_scheme(WORKQ_GENERATOR, 0, K, q0.shape[1], edit=True, sigma=index.sigma, n_text=index.n))
    tape = pack_tape(t.side, t.qpos, t.lo, t.hi)
    approx.frontier_step = check
    try:
        approx.scheme_search(index, torch.from_numpy(q0.astype(np.int32)).to(index.device),
                             torch.from_numpy(tape).to(index.device), torch.ones(CHUNK, dtype=torch.bool,
                                                                                 device=index.device),
                             edit=True, s_cap=64, h_cap=32, k=K)
        check.capture, chunk0_steps = False, check.n
        require_rows("the checked pass", search_queries(index, queries, **kw), rows)
    finally:
        approx.frontier_step = kernel
    step, live_in, ctx, state, live, (hits0, cnt0, flags0), hits_after = steps[0]
    nxt, nxt_live = torch.empty_like(state), torch.empty_like(live)
    hits, hit_cnt, flags = (x.clone() for x in (hits0, cnt0, flags0))
    dead = torch.arange(ctx.s_cap, device=state.device) >= live[:, None]
    zeroed = state.clone()
    zeroed[SZ][dead] = 0  # step_figures finds the live slots by sz

    def launch():
        hit_cnt.copy_(cnt0)
        frontier_step(ctx, state, live, nxt, nxt_live, hits, hit_cnt, flags, checked=True)

    nxt.fill_(-1)  # a sentinel: the kernel writes only the children and the next live counts
    nxt_live.fill_(-1)
    hits.copy_(hits0)
    flags.copy_(flags0)
    launch()
    children, new_flags = torch.where(nxt[SZ] > 0, nxt, 0), int((flags != flags0).sum())
    fig = step_figures(ctx, zeroed, children)
    new_hits = hits_after - int(cnt0.sum())
    b, by = frontier_bound(ctx, fig, new_hits, new_flags)
    flush_buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=index.device)
    flush = lambda: flush_buf.fill_(1)  # noqa: E731
    counts = torch.bincount(live.clamp(max=33).long(), minlength=34).tolist()
    lists = torch.nn.functional.pad(live, (0, -len(live) % 8)).reshape(-1, 8).sum(dim=1)  # a warp's: 8 lanes
    rounds = torch.bincount(((lists + 31) // 32).clamp(max=4).long(), minlength=5).tolist()
    row = dict(
        name="frontier_step", route="cuda", source="sahara_tpu_torch/kernels/csrc/frontier.cu",
        replaces="sahara_tpu/engine/approx.py:161", max_abs_err=check.err, steps_checked=check.n,
        chunk0_steps_checked=chunk0_steps,
        **kernel_times(launch, "frontier_kernel", flush),
        plain_ms=time_ms(lambda: frontier_step_plain(ctx, state, live, torch.empty_like(nxt), torch.empty_like(live),
                                                     hits.clone(), cnt0.clone(), flags.clone()), 5),
        bound_ms=b, bound_by=by, library_ms=None,
        launches=launches["frontier_step"], new_hits=new_hits, **fig,
        lanes_by_live={"0": counts[0], "1": counts[1], "2-4": sum(counts[2:5]), "5-8": sum(counts[5:9]),
                       "9-32": sum(counts[9:33]), "33+": counts[33]},
        warps_by_rounds={"0": rounds[0], "1": rounds[1], "2": rounds[2], "3": rounds[3], "4+": rounds[4]},
        shape=f"{ctx.lanes} lanes x s_cap {ctx.s_cap}, {live_in} live slots in (step {step}, the first attempt's "
              f"widest), sigma={ctx.sigma}, m={ctx.m}",
    )
    row["ms_again"] = kernel_device_ms(launch, "frontier_kernel", 20)
    run = lambda: search_queries(index, queries, **kw)  # noqa: E731
    row["pass_ms"], row["pass_launches"] = kernel_device_total(run, "frontier_kernel")
    print(f"frontier_step: {chunk0_steps} steps of chunk 0 and {check.n - chunk0_steps} of a whole pass (its retry "
          f"searches' own caps included) equal to the plain step; widest {row['shape']}: lanes by live "
          f"slots {row['lanes_by_live']}, warps (8 lanes) by rounds {row['warps_by_rounds']}; {fig}; plain "
          f"{row['plain_ms']:.3f} ms; least-work bound {b:.5f} ms by {by}; warm again {row['ms_again']:.4f} ms; a pass "
          f"{row['pass_ms']:.2f} ms in {row['pass_launches']} launches", flush=True)

    passes = timed_passes(run, rows, "approx")
    dt = sorted(passes)[1]
    out.update(passes_s=passes, pass_s=dt, reads_per_s=len(queries) / 2 / dt, syncs=count_syncs(run))
    print(f"approx path: {out['reads_per_s']:.1f} reads/s (median of 3: {dt * 1e3:.1f} ms), {out['syncs']} syncs",
          flush=True)

    # the CLI's --engine approx on the first APPROX_CLI_QUERIES strand queries
    path = os.path.join(tmp, "approx_out.txt")
    reset_launches()
    wall, log = run_cli(["search", "-q", reads, "-i", fasta + ".idx", "-o", path, "-e", str(K), "-d", "lev",
                         "--engine", "approx", "--limit_queries", str(APPROX_CLI_QUERIES)])
    require_launches(LAUNCHES, ("frontier_step",), "CLI approx")
    _, sha, lines = search_output(path, JAX_APPROX_CLI_SHA256, JAX_APPROX_CLI_LINES, "the CLI's --engine approx")
    out["cli"] = dict(wall_s=wall, lines=lines, sha256=sha, stats=stats_block(log), launches=dict(LAUNCHES))
    print(f"cli search --engine approx: {lines} lines equal the JAX CLI's, wall {wall:.2f} s", flush=True)
    return out, row


def sharded_phase(tmp: str, fasta: str, reads: str, queries: np.ndarray, sv_rows: np.ndarray,
                  n_queries: np.ndarray, n_rows: np.ndarray) -> dict:
    """The interval-sharded index: ``index --max_shard_mb 16`` of the
    workload's reference, the CLI's ``search`` on it against the JAX CLI's,
    then ``search_queries_sharded`` in process: resident (three timed passes
    after a warm one, a profiled pass), swap (one pass, with each shard's
    upload seconds), and the N reads, whose fallback is deferred to K5."""
    from sahara_tpu_torch.engine.device import device_bytes
    from sahara_tpu_torch.engine.driver import RESIDENT_MARGIN, search_queries_sharded
    from sahara_tpu_torch.index.shard import ShardedIndex, load_any_index
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches

    sdir = os.path.join(tmp, "sharded")
    os.makedirs(sdir)
    sfasta = os.path.join(sdir, "ref.fasta")
    os.link(fasta, sfasta)
    index_s, log = run_cli(["index", sfasta, "--max_shard_mb", str(SHARD_MB)])
    sh = load_any_index(sfasta + ".idx")
    if not isinstance(sh, ShardedIndex) or sh.num_shards != 3 or "  shards: 3" not in log:
        raise AssertionError("index --max_shard_mb 16 did not write three shards")
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    resident_bytes = sum(device_bytes(h, include_rev=False) for h in sh.shards)
    out = dict(index_s=index_s, index_stats=stats_block(log), shards_n=[h.n for h in sh.shards],
               windows=[o.tolist() for o in sh.seq_off], resident_bytes=resident_bytes, free_bytes=free,
               budget=free - RESIDENT_MARGIN, whole_shard_bytes=[device_bytes(h) for h in sh.shards])
    print(f"sharded: index {index_s:.1f} s, {sh.num_shards} shards n={out['shards_n']} windows {out['windows']}; "
          f"resident views {resident_bytes} B, free {free} B, budget {out['budget']} B (margin {RESIDENT_MARGIN} B)",
          flush=True)

    path = os.path.join(sdir, "out.txt")
    reset_launches()
    wall, log = run_cli(["search", "-q", reads, "-i", sfasta + ".idx", "-o", path, "-e", str(K), "-d", "lev"])
    require_launches(LAUNCHES, ("rank_all", "seed_scan", "verify"), "CLI sharded search")
    _, sha, lines = search_output(path, JAX_SHARD_SHA256, JAX_SHARD_LINES, "the CLI's sharded search")
    if sha != JAX_CLI_SHA256:
        raise AssertionError("the sharded CLI output differs from the unsharded JAX CLI output")
    out["cli"] = dict(wall_s=wall, reads_per_s=len(queries) / 2 / wall, stats=stats_block(log),
                      launches=dict(LAUNCHES), lines=lines, sha256=sha)
    print(f"cli sharded search: {lines} lines, sha256 {sha} (JAX_SHARD_* and JAX_CLI_*), wall {wall:.2f} s; stats "
          f"{json.dumps(out['cli']['stats'])}", flush=True)

    kw = dict(k=K, edit=True, chunk=CHUNK)
    sh = load_any_index(sfasta + ".idx")
    reset_launches()
    t0 = time.perf_counter()
    res = search_queries_sharded(sh, queries, **kw)
    torch.cuda.synchronize()
    out["resident_first_s"] = time.perf_counter() - t0
    out["resident_launches"] = dict(LAUNCHES)
    require_launches(out["resident_launches"], ("rank_all", "seed_scan", "verify"), "sharded resident")
    if sh.resident is None or not np.array_equal(sorted_rows(res), sv_rows):
        raise AssertionError("the resident sharded search differs from the seed-and-verify rows")
    run = lambda: search_queries_sharded(sh, queries, **kw)  # noqa: E731
    run()
    torch.cuda.reset_peak_memory_stats()
    passes = timed_passes(run, sv_rows, "sharded resident")
    dt = sorted(passes)[1]
    out.update(resident_passes_s=passes, resident_pass_s=dt, resident_reads_per_s=len(queries) / 2 / dt,
               resident_max_memory_allocated=torch.cuda.max_memory_allocated(), resident_profile=profile_pass(run))
    busy = out["resident_profile"]["device_busy_ms"]
    print(f"sharded resident: {out['resident_reads_per_s']:.1f} reads/s (median of 3: {dt * 1e3:.1f} ms), device busy "
          f"{busy:.1f} ms ({busy / (dt * 1e3) * 100:.1f}%), first pass {out['resident_first_s']:.2f} s with the uploads, "
          f"launches {json.dumps(out['resident_launches'])}, max_memory_allocated "
          f"{out['resident_max_memory_allocated']} B", flush=True)

    lines_cb: list[str] = []
    reset_launches()
    t0 = time.perf_counter()
    res = search_queries_sharded(sh, queries, resident_budget=0, verbose_cb=lines_cb.append, **kw)
    torch.cuda.synchronize()
    out["swap_pass_s"] = time.perf_counter() - t0
    out["swap_launches"] = dict(LAUNCHES)
    out["swap_upload_s"] = [float(m.group(1)) for m in map(re.compile(r"uploaded in ([\d.]+)s").search, lines_cb) if m]
    if len(out["swap_upload_s"]) != 3 or not np.array_equal(sorted_rows(res), sv_rows):
        raise AssertionError("the swapped sharded search differs from the seed-and-verify rows")
    print(f"sharded swap: one pass {out['swap_pass_s']:.2f} s ({len(queries) / 2 / out['swap_pass_s']:.1f} reads/s), "
          f"uploads s {out['swap_upload_s']}, launches {json.dumps(out['swap_launches'])}", flush=True)

    reset_launches()
    res = search_queries_sharded(sh, n_queries, **kw)
    out["fallback_launches"] = dict(LAUNCHES)
    require_launches(out["fallback_launches"], ("workq_step",), "sharded deferred fallback")
    if sh.resident is not None or not np.array_equal(sorted_rows(res), n_rows):
        raise AssertionError("the sharded N reads differ from the unsharded auto rows")
    print(f"sharded N reads: {len(n_rows)} rows equal the unsharded auto rows; the fallback went to K5 on whole shards "
          f"({out['fallback_launches']['workq_step']} launches)", flush=True)
    return out


def pair_passes(label: str, runs: dict, n_reads: int) -> dict:
    """Each of ``runs`` (name -> (run, check)) as a pass: its launches from
    zero, three timed passes (``check`` holds each result) and a profiled
    pass (device busy share), the single-device pass and the mesh pass in
    turn."""
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches

    out = {}
    for name, (run, check) in runs.items():
        reset_launches()
        t0 = time.perf_counter()
        check(run())
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
        passes = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
            check(res)
        dt = sorted(passes)[1]
        prof = profile_pass(run)
        busy = prof["device_busy_ms"]
        out[name] = dict(first_pass_s=first, passes_s=passes, pass_s=dt, reads_per_s=n_reads / dt, launches=launches,
                         device_busy_ms=busy, busy_share=busy / (dt * 1e3), top_device_ms=prof["top_device_ms"],
                         top_host_tottime_ms=prof["top_host_tottime_ms"])
        print(f"  {label}, {name}: {dt * 1e3:.1f} ms (median of 3) -> {n_reads / dt:.1f} reads/s, device busy "
              f"{busy:.1f} ms ({busy / (dt * 1e3) * 100:.1f}%), launches {json.dumps(launches)}; host by tottime "
              f"{[(f, round(ms, 1)) for f, ms, _ in prof['top_host_tottime_ms'][:4]]}", flush=True)
    return out


def rows_check(want: np.ndarray, what: str):
    def check(res) -> None:
        if not np.array_equal(sorted_rows(res), want):
            raise AssertionError(f"{what} gave another hit set")
    return check


def mesh_phase(host, queries: np.ndarray, sv_rows: np.ndarray, n_queries: np.ndarray, n_rows: np.ndarray,
               ref: np.ndarray) -> dict:
    """The data mesh, the card listed MESH_ENTRIES times (the machine has one
    GPU): the index replicated (one upload), the workload through ``auto``
    (seed-and-verify, exact parts) and ``workq`` against ``JAX_SHA256``, the
    N reads against their single-device rows, the short-read prefix through
    ``auto``, which takes the work-queue engine on a mesh, against
    ``JAX_E1_WORKQ_PREFIX_*``, and ``distributed_scheme_search`` on chunk 0
    against one ``scheme_search``; each beside its single-device pass on the
    same upload."""
    from sahara_tpu_torch.engine import approx
    from sahara_tpu_torch.engine.driver import load_scheme, search_queries
    from sahara_tpu_torch.engine.tape import compile_tape
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches
    from sahara_tpu_torch.kernels.frontier import pack_tape
    from sahara_tpu_torch.parallel import data_mesh, distributed_scheme_search, replicate_index
    from sahara_tpu_torch.sim.workload import short_reads

    card = torch.device("cuda", 0)
    mesh = data_mesh(devices=[card] * MESH_ENTRIES)
    reset_launches()
    t0 = time.perf_counter()
    reps = replicate_index(host, mesh)
    torch.cuda.synchronize()
    out = dict(entries=MESH_ENTRIES, upload_s=time.perf_counter() - t0, upload_launches=dict(LAUNCHES))
    require_launches(out["upload_launches"], ("rank_all",), "mesh upload")
    if any(r is not reps[0] for r in reps):
        raise AssertionError("the mesh uploaded the index more than once to one card")
    one, n_reads = reps[0], len(queries) // 2
    print(f"mesh: {MESH_ENTRIES} x {card}, one upload {out['upload_s']:.2f} s", flush=True)

    kw = dict(k=K, edit=True, chunk=CHUNK)
    for label, extra, kernels in (("auto", {}, ("seed_scan", "verify")),
                                  ("workq", dict(engine="workq", generator_name=WORKQ_GENERATOR), ("workq_step",))):
        run_kw = {**kw, **extra}
        check = rows_check(sv_rows, f"the mesh's {label} pass")
        out[label] = pair_passes(f"mesh {label} ({JAX_HITS} rows, JAX_SHA256)", {
            "single": (lambda: search_queries(one, queries, **run_kw), check),
            "mesh": (lambda: search_queries(reps, queries, mesh=mesh, **run_kw), check),
        }, n_reads)
        require_launches(out[label]["mesh"]["launches"], kernels, f"mesh {label}")

    reset_launches()
    got = sorted_rows(search_queries(reps, n_queries, mesh=mesh, **kw))
    out["fallback"] = dict(launches=dict(LAUNCHES), hits=len(got))
    require_launches(out["fallback"]["launches"], ("seed_scan", "verify", "workq_step"), "mesh fallback")
    if not np.array_equal(got, n_rows):
        raise AssertionError("the N reads on the mesh differ from their single-device rows")
    print(f"mesh fallback: the N reads' {len(got)} rows equal the single-device rows", flush=True)

    # short reads: exact parts do not apply at m=36, k=3, so a mesh takes the
    # work-queue engine (the reference's mesh route), one device SV-e1
    sub = short_reads(ref)[: 2 * E1_PREFIX_READS]
    e1_kw = dict(k=E1_K, edit=True, chunk=CHUNK, generator_name=WORKQ_GENERATOR)
    wq_rows = sorted_rows(search_queries(reps, sub, mesh=mesh, **e1_kw))
    e1_rows = sorted_rows(search_queries(one, sub, **e1_kw))
    only_e1 = {tuple(r) for r in e1_rows[:, :3].tolist()} - {tuple(r) for r in wq_rows[:, :3].tolist()}
    out["short"] = dict(hits=len(wq_rows), sha256=rows_sha(wq_rows), sv_e1_hits=len(e1_rows),
                        rows_only_sv_e1=len(only_e1), other_errors=len(e1_rows) - len(wq_rows) - len(only_e1))
    print(f"mesh short reads ({E1_PREFIX_READS} reads, k={E1_K}): {len(wq_rows)} rows sha256 {out['short']['sha256']} "
          f"(JAX_E1_WORKQ_PREFIX: {JAX_E1_WORKQ_PREFIX_HITS}); one device's SV-e1 {len(e1_rows)} rows "
          f"(JAX_E1_PREFIX: {JAX_E1_PREFIX_HITS}), {len(only_e1)} positions only SV-e1 finds", flush=True)
    if len(wq_rows) != JAX_E1_WORKQ_PREFIX_HITS or out["short"]["sha256"] != JAX_E1_WORKQ_PREFIX_SHA256:
        raise AssertionError("the short reads on the mesh differ from the JAX package's work-queue rows")
    if len(e1_rows) != JAX_E1_PREFIX_HITS or rows_sha(e1_rows) != JAX_E1_PREFIX_SHA256:
        raise AssertionError("the short reads' SV-e1 rows differ from the JAX package's")
    out["short"].update(pair_passes("mesh short reads", {
        "single": (lambda: search_queries(one, sub, **e1_kw), rows_check(e1_rows, "SV-e1 on the short reads")),
        "mesh": (lambda: search_queries(reps, sub, mesh=mesh, **e1_kw),
                 rows_check(wq_rows, "the mesh's short reads")),
    }, E1_PREFIX_READS))
    require_launches(out["short"]["mesh"]["launches"], ("workq_step",), "mesh short reads")
    if "seed_scan" in out["short"]["mesh"]["launches"] or "verify" in out["short"]["mesh"]["launches"]:
        raise AssertionError("the short reads on the mesh took seed-and-verify")

    # the frontier engine's one search at fixed caps, chunk 0
    m = queries.shape[1]
    tape = compile_tape(load_scheme(WORKQ_GENERATOR, 0, K, m, edit=True, sigma=host.sigma, n_text=host.n))
    q0 = queries[:CHUNK]
    words = torch.from_numpy(pack_tape(tape.side, tape.qpos, tape.lo, tape.hi)).to(card)
    q0_dev, act = torch.from_numpy(q0.astype(np.int32)).to(card), torch.ones(CHUNK, dtype=torch.bool, device=card)
    hits, cnt, flags = approx.scheme_search(one, q0_dev, words, act, edit=True, s_cap=64, h_cap=32, k=K)
    ns = tape.num_searches
    want = (*hits.reshape(3, CHUNK, ns, 32), cnt.reshape(CHUNK, ns), *flags.cpu().bool().reshape(2, CHUNK, ns))

    def same(res) -> None:
        got_hits, total = res
        fields = (got_hits.lb, got_hits.sz, got_hits.err, got_hits.count, got_hits.frontier_overflow,
                  got_hits.hit_overflow)
        if not all(torch.equal(a, b) for a, b in zip(fields, want)) or total != int(cnt.sum()):
            raise AssertionError("distributed_scheme_search differs from one scheme_search")

    out["scheme"] = pair_passes(f"scheme search of chunk 0 ({CHUNK} queries, s_cap 64, h_cap 32)", {
        "single": (lambda: (approx.scheme_search(one, q0_dev, words, act, edit=True, s_cap=64, h_cap=32, k=K), None),
                   lambda res: None),
        "mesh": (lambda: distributed_scheme_search(mesh, reps, q0, tape, edit=True), same),
    }, CHUNK // 2)
    require_launches(out["scheme"]["mesh"]["launches"], ("frontier_step",), "mesh scheme search")
    out["scheme"].update(hits=int(cnt.sum()), overflow_lanes=int(flags.bool().any(dim=0).sum()))
    print(f"mesh scheme search: SearchHits equal one scheme_search's ({out['scheme']['hits']} hit intervals, "
          f"{out['scheme']['overflow_lanes']} overflowing lanes)", flush=True)
    return out


def interval_mesh_phase(tmp: str, queries: np.ndarray, sv_rows: np.ndarray) -> dict:
    """``distributed_interval_search`` over phase sharded's index, shard i
    on mesh entry i (the card three times): the whole workload at k=2 edit
    distance against ``JAX_SHA256``, K5 searching and K7 locating."""
    from sahara_tpu_torch.engine.device import device_bytes
    from sahara_tpu_torch.engine.driver import load_scheme
    from sahara_tpu_torch.engine.tape import compile_tape
    from sahara_tpu_torch.index.shard import load_any_index
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches
    from sahara_tpu_torch.parallel import data_mesh
    from sahara_tpu_torch.parallel.interval import distributed_interval_search

    sh = load_any_index(os.path.join(tmp, "sharded", "ref.fasta.idx"))
    mesh = data_mesh(devices=[torch.device("cuda", 0)] * sh.num_shards)
    tape = compile_tape(load_scheme(WORKQ_GENERATOR, 0, K, queries.shape[1], edit=True, sigma=sh.sigma,
                                    n_text=sum(h.n for h in sh.shards)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = distributed_interval_search(mesh, sh, queries, tape, edit=True, chunk=CHUNK)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rows = sorted_rows(res)
    out = dict(shards=sh.num_shards, windowed_gids=sh.windowed_gids.tolist(), pass_s=dt,
               reads_per_s=len(queries) / 2 / dt, launches=dict(LAUNCHES), hits=len(rows), sha256=rows_sha(rows),
               shard_bytes=[device_bytes(h, full_sa=False) for h in sh.shards],
               max_memory_allocated=torch.cuda.max_memory_allocated())
    require_launches(out["launches"], ("rank_all", "workq_step", "lf_walk"), "interval mesh")
    print(f"interval mesh: {sh.num_shards} shards on {mesh.size} x cuda:0, {len(rows)} rows sha256 {out['sha256']} "
          f"(JAX_SHA256), one pass {dt:.2f} s with the uploads ({out['reads_per_s']:.1f} reads/s); shards' bytes on "
          f"the card {out['shard_bytes']}, max_memory_allocated {out['max_memory_allocated']} B; launches "
          f"{json.dumps({k: v for k, v in out['launches'].items() if v})}", flush=True)
    if len(rows) != JAX_HITS or out["sha256"] != JAX_SHA256 or not np.array_equal(rows, sv_rows):
        raise AssertionError("the interval mesh search differs from the JAX package's rows")
    return out


# One rank of phase multihost: the CLI's main, as ``python -m
# sahara_tpu_torch`` runs it, then the rank's launch counts and the wall
# seconds of main.
MH_RANK = ("import json, sys, time; from sahara_tpu_torch.cli.main import main; "
           "from sahara_tpu_torch.kernels import LAUNCHES; t0 = time.perf_counter(); rc = main(sys.argv[1:]); "
           "print('rank ' + json.dumps(dict(launches=LAUNCHES, main_s=time.perf_counter() - t0)), flush=True); "
           "sys.exit(rc)")
MH_RANKS = 2


def multihost_phase(tmp: str, fasta: str, reads: str) -> dict:
    """MH_RANKS processes of the CLI's ``search -e 2 -d lev --mh_*`` sharing
    the card (gloo on localhost): rank 0's merged file against
    ``JAX_CLI_*``, no part file left, each rank's launches, wall and stats
    block."""
    import socket

    mdir = os.path.join(tmp, "multihost")
    os.makedirs(mdir)
    out_path = os.path.join(mdir, "out.txt")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [repo, os.environ.get("PYTHONPATH")])))
    argv = ["search", "-q", reads, "-i", fasta + ".idx", "-o", out_path, "-e", str(K), "-d", "lev",
            "--mh_coordinator", f"127.0.0.1:{port}", "--mh_num_processes", str(MH_RANKS)]
    procs, ranks = [], []
    t0 = time.perf_counter()
    try:
        for r in range(MH_RANKS):
            procs.append(subprocess.Popen([sys.executable, "-c", MH_RANK, *argv, "--mh_process_id", str(r)], cwd=repo,
                                          env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for r, p in enumerate(procs):
            log = p.communicate(timeout=600)[0].decode(errors="replace")
            if p.returncode != 0:
                raise AssertionError(f"multi-host rank {r} exited {p.returncode}: {log[-2000:]}")
            info = json.loads(re.search(r"^rank (\{.*\})$", log, re.M).group(1))
            ranks.append(dict(info, done_s=time.perf_counter() - t0, stats=stats_block(log),
                              queries=re.findall(r"^(?:fwd|bwd) queries: (\d+)$", log, re.M)))
            require_launches(info["launches"], ("rank_all", "seed_scan", "verify"), f"multi-host rank {r}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    _, sha, lines = search_output(out_path, JAX_CLI_SHA256, JAX_CLI_LINES, "the multi-host search (rank 0's merge)")
    left = [f for f in os.listdir(mdir) if f != "out.txt"]
    if left:
        raise AssertionError(f"part files left after the merge: {left}")
    out = dict(ranks=ranks, wall_s=time.perf_counter() - t0, lines=lines, sha256=sha)
    for r, info in enumerate(ranks):
        print(f"multi-host rank {r}: main {info['main_s']:.2f} s, done {info['done_s']:.2f} s after the start, strand "
              f"queries {info['queries']}, launches {json.dumps({k: v for k, v in info['launches'].items() if v})}; "
              f"stats {json.dumps(info['stats'])}", flush=True)
    print(f"multi-host: {MH_RANKS} ranks on one card, {out['wall_s']:.2f} s wall, merged output {lines} lines "
          "(JAX_CLI_*)", flush=True)
    return out


def corpus_phase(tmp: str) -> dict:
    """The synthetic genome (``sim/corpus.py``): its records through the
    CLI's ``index``, plain and ``--max_shard_mb`` CORPUS_SHARD_MB, and the
    reads that pass the low-complexity filter through ``auto``
    (seed-and-verify and its fallback), ``workq``, ``approx`` and
    ``search_queries_sharded`` (resident and swap), each against the JAX
    package's rows (``JAX_CORPUS_*``); the filtered reads (poly-A) through
    the frontier engine, whose buffers overflow after every retry (the
    reference raises alike), and the work-queue engine's hit volume for
    them, unlocated."""
    from sahara_tpu_torch.alphabet import D_DNA5
    from sahara_tpu_torch.engine import driver
    from sahara_tpu_torch.engine.device import DeviceIndex
    from sahara_tpu_torch.engine.driver import load_scheme, search_queries, search_queries_sharded
    from sahara_tpu_torch.engine.tape import compile_tape
    from sahara_tpu_torch.index.fmindex import load_index
    from sahara_tpu_torch.index.shard import ShardedIndex, load_any_index
    from sahara_tpu_torch.io.fasta import FastaRecord, write_fasta
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches
    from sahara_tpu_torch.sim.workload import corpus_workload

    t0 = time.perf_counter()
    records, queries, low = corpus_workload()
    genome_sha, queries_sha = rows_sha(np.concatenate(records)), rows_sha(queries)
    if genome_sha != CORPUS_GENOME_SHA256 or queries_sha != CORPUS_QUERIES_SHA256:
        raise AssertionError("the corpus workload differs from the one the JAX package's rows were recorded on")
    cdir, sdir = os.path.join(tmp, "corpus"), os.path.join(tmp, "corpus_sharded")
    os.makedirs(cdir)
    os.makedirs(sdir)
    cfasta, sfasta = os.path.join(cdir, "genome.fasta"), os.path.join(sdir, "genome.fasta")
    write_fasta(cfasta, [FastaRecord(f"chr{i}", D_DNA5.rank_to_char(r)) for i, r in enumerate(records)], line_length=0)
    os.link(cfasta, sfasta)
    out = dict(workload_s=time.perf_counter() - t0, records=[len(r) for r in records], reads=len(queries) // 2,
               low_complexity_reads=len(low) // 2, n_gap_chars=int(sum((r == 5).sum() for r in records)))
    out["index_s"], _ = run_cli(["index", cfasta])
    out["sharded_index_s"], log = run_cli(["index", sfasta, "--max_shard_mb", str(CORPUS_SHARD_MB)])
    sh = load_any_index(sfasta + ".idx")
    if not isinstance(sh, ShardedIndex):
        raise AssertionError(f"index --max_shard_mb {CORPUS_SHARD_MB} wrote no sharded index")
    out.update(shards_n=[h.n for h in sh.shards], windowed_gids=sh.windowed_gids.tolist())
    print(f"corpus: {sum(out['records'])} chars in records {out['records']} ({out['n_gap_chars']} N), {out['reads']} "
          f"reads ({out['low_complexity_reads']} low-complexity reads filtered out); index {out['index_s']:.1f} s, "
          f"sharded {out['sharded_index_s']:.1f} s: {sh.num_shards} shards n={out['shards_n']}, windowed "
          f"{out['windowed_gids']}", flush=True)

    index = DeviceIndex.from_host(load_index(cfasta + ".idx"))
    kw = dict(k=K, edit=True, chunk=CHUNK)
    paths = {
        "auto": (lambda: search_queries(index, queries, **kw), ("seed_scan", "verify", "workq_step"),
                 JAX_CORPUS_HITS, JAX_CORPUS_SHA256, None),
        "workq": (lambda: search_queries(index, queries, engine="workq", generator_name=WORKQ_GENERATOR, **kw),
                  ("workq_step",), JAX_CORPUS_WORKQ_HITS, JAX_CORPUS_WORKQ_SHA256, None),
        "approx": (lambda: search_queries(index, queries, engine="approx", generator_name=WORKQ_GENERATOR, **kw),
                   ("frontier_step",), JAX_CORPUS_APPROX_PREFIX_HITS, JAX_CORPUS_APPROX_PREFIX_SHA256,
                   CORPUS_APPROX_PREFIX),
        "sharded": (lambda: search_queries_sharded(sh, queries, **kw), ("rank_all", "seed_scan", "verify"),
                    JAX_CORPUS_SHARD_HITS, JAX_CORPUS_SHARD_SHA256, None),
        "swap": (lambda: search_queries_sharded(sh, queries, resident_budget=0, **kw), ("rank_all", "verify"),
                 JAX_CORPUS_SHARD_HITS, JAX_CORPUS_SHARD_SHA256, None),
    }
    all_rows = {}
    for name, (run, kernels, want_hits, want_sha, prefix) in paths.items():
        reset_launches()
        with recorded(driver, "_run_sv") as sv_calls:
            t0 = time.perf_counter()
            rows = sorted_rows(run())
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        checked = rows if prefix is None else rows[rows[:, 0] < prefix]
        all_rows[name] = rows
        fallback = sum(int(c[2][1].sum()) for c in sv_calls)
        out[name] = dict(pass_s=dt, reads_per_s=len(queries) / 2 / dt, hits=len(rows), sha256=rows_sha(rows),
                         checked_hits=len(checked), launches={k: v for k, v in LAUNCHES.items() if v},
                         fallback_queries=fallback, fallback_share=fallback / len(queries))
        require_launches(out[name]["launches"], kernels, f"corpus {name}")
        print(f"corpus {name}: {len(rows)} rows sha256 {out[name]['sha256']}"
              + (f"; first {prefix} queries {len(checked)} rows" if prefix else "")
              + f" (JAX package {want_hits}, {want_sha}); one pass {dt:.2f} s "
              f"({out[name]['reads_per_s']:.1f} reads/s), SV fallback {fallback} of {len(queries)} strand queries ({out[name]['fallback_share'] * 100:.3f}%), "
              f"launches {json.dumps(out[name]['launches'])}", flush=True)
        if len(checked) != want_hits or rows_sha(checked) != want_sha:
            raise AssertionError(f"the corpus's {name} rows differ from the JAX package's")
    if not out["auto"]["fallback_queries"]:
        raise AssertionError("no corpus read left seed-and-verify for its fallback")
    mine, theirs = ({tuple(r) for r in all_rows[x][:, :3].tolist()} for x in ("approx", "auto"))
    out["approx"].update(only_approx=len(mine - theirs), only_auto=len(theirs - mine))
    print(f"corpus approx against auto: {len(mine - theirs)} positions only approx finds, {len(theirs - mine)} only "
          "auto finds", flush=True)
    del all_rows, mine, theirs

    # the filtered reads: every rung of the frontier engine's cap ladder
    # overflows, and the work-queue engine's hit intervals hold far more
    # rows than the positions they locate
    reset_launches()
    try:
        search_queries(index, low, engine="approx", generator_name=WORKQ_GENERATOR, **kw)
    except RuntimeError as e:
        if "overflowed its frontier/hit buffers after retries" not in str(e):
            raise
    else:
        raise AssertionError("the frontier engine searched the poly-A reads without overflowing")
    require_launches(LAUNCHES, ("frontier_step",), "corpus low-complexity approx")
    tape = compile_tape(load_scheme("h2-k2", 0, K, queries.shape[1], edit=True, sigma=6, n_text=index.n))
    t0 = time.perf_counter()
    found = driver._workq_hits(index, torch.from_numpy(low).to(index.device), tape, edit=True,
                               active=np.ones(len(low), dtype=bool), chunk=CHUNK)
    volume = np.zeros(len(low))
    for start, _, ns, hits in found:
        np.add.at(volume, start + hits.lane // ns, hits.sz.astype(np.float64))
    out["low_complexity"] = dict(workq_s=time.perf_counter() - t0, workq_rows=int(volume.sum()),
                                 workq_rows_max=int(volume.max()), workq_intervals=sum(h.n_hits for *_, h in found))
    print(f"corpus low-complexity reads ({len(low)} strand queries): approx overflows after its retries (as the JAX "
          f"package's); the work-queue engine's {out['low_complexity']['workq_intervals']} hit intervals hold "
          f"{out['low_complexity']['workq_rows']} rows before the merge (at most "
          f"{out['low_complexity']['workq_rows_max']} for one query), {out['low_complexity']['workq_s']:.2f} s",
          flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from sahara_tpu_torch.bench_rank import run_size
    from sahara_tpu_torch.engine.device import DeviceIndex
    from sahara_tpu_torch.engine.driver import search_queries
    from sahara_tpu_torch.engine.seedverify import StageTimer
    from sahara_tpu_torch.index.fmindex import load_index
    from sahara_tpu_torch.kernels import LAUNCHES, reset_launches
    from sahara_tpu_torch.kernels._build import KERNEL_SOURCES, build_all, source
    from sahara_tpu_torch.sim.workload import bench_workload

    report: dict = {}
    card = card_line()
    print(card, flush=True)
    t_start = t0 = time.perf_counter()
    ptxas = build_all([source(name) for name in KERNEL_SOURCES])
    report["build_s"] = time.perf_counter() - t0
    report["sm_clocks_s"] = sm_clocks_s()
    print(f"build: {report['build_s']:.1f} s", flush=True)
    for name, log in sorted(ptxas.items()):
        for row in registers(log):
            print(f"  {name}.cu {row}", flush=True)

    t0 = time.perf_counter()
    ref, queries = bench_workload()
    report["workload_s"] = time.perf_counter() - t0
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    report["cli"], fasta, reads = cli_index_phase(tmp.name, ref, queries)
    host = load_index(fasta + ".idx")
    report["index_build_s"] = report["cli"]["index_s"]
    print(f"workload {report['workload_s']:.1f} s, bidirectional index through the CLI {report['index_build_s']:.1f} s "
          f"(n={host.n}, {len(queries)} strand queries)", flush=True)

    # K1-K3 vs plain, on an uploaded copy of the forward index
    kernels = kernel_phases(DeviceIndex.from_host(host, include_rev=False), queries, np.random.default_rng(7), ref,
                            ptxas)
    # K1 on its path: the j-mer table's levels at upload (2 to 524,288 positions)
    upload = lambda: DeviceIndex.from_host(host, include_rev=False)  # noqa: E731
    k1 = kernels[0]
    upload()  # warm
    k1["upload_ms"], k1["upload_launches"] = kernel_device_total(upload, "rank_all_kernel")
    print(f"rank_all in one upload: {k1['upload_launches']} launches, device {k1['upload_ms']:.4f} ms", flush=True)
    for row in kernels:
        print_times(row)
    mask = next(row for row in kernels if row["name"] == "seed_bad_mask")
    print(f"seed_bad_mask: {mask['shape']}: bound {mask['bound_ms']:.4f} ms ({mask['bound_by']}), plain "
          f"{mask['plain_ms']:.4f} ms; a {CHUNK}-query chunk {mask['chunk_ms']:.4f} ms", flush=True)
    sass = next(row for row in kernels if row["name"] == "verify")["steady_row_sass"]
    print(f"verify steady loop, SASS instructions a row by pipe: {sass or 'not measured'}", flush=True)

    # seed-and-verify path: upload + one search pass, with launch counts from zero
    kw = dict(k=K, edit=True, chunk=CHUNK)
    reset_launches()
    t0 = time.perf_counter()
    index = DeviceIndex.from_host(host, include_rev=False)
    torch.cuda.synchronize()
    report["upload_s"] = time.perf_counter() - t0
    res = search_queries(index, queries, **kw)
    launches = dict(LAUNCHES)
    report["launches"] = launches
    require_launches(launches, ("rank_all", "seed_scan", "verify", "seed_bad_mask"), "seed-and-verify")
    rows = sorted_rows(res)
    sha = hashlib.sha256(rows.tobytes()).hexdigest()
    print(f"hits {len(rows)} (JAX package {JAX_HITS}, BENCH_r05 bench.py {BENCH_R05_HITS}) sha256 {sha}", flush=True)
    if len(rows) != JAX_HITS or sha != JAX_SHA256:
        raise AssertionError("hit set differs from the JAX package's")

    torch.cuda.reset_peak_memory_stats()
    passes = timed_passes(lambda: search_queries(index, queries, **kw), rows, "seed-and-verify")
    dt = sorted(passes)[1]
    timer = StageTimer(index.device)
    search_queries(index, queries, timer=timer, **kw)
    stages = timer.totals()
    report.update(
        passes_s=passes, pass_s=dt, reads_per_s=len(queries) / 2 / dt, stage_ms=stages,
        max_memory_allocated=torch.cuda.max_memory_allocated(), hits=len(rows), sha256=sha,
    )
    print(f"main path: {report['reads_per_s']:.1f} reads/s (median of 3: {dt * 1e3:.1f} ms for {len(queries) // 2} reads, "
          f"both strands), stages ms {json.dumps({k: round(v, 3) for k, v in stages.items()})}, "
          f"max_memory_allocated {report['max_memory_allocated']} B", flush=True)
    print(f"passes s {passes}", flush=True)

    # sampled LF-walk locate (K7): no full suffix array on the card
    sampled = DeviceIndex.from_host(host, full_sa=False, include_rev=False)
    sub = queries[: 2 * SAMPLED_READS]
    reset_launches()
    t0 = time.perf_counter()
    res_s = search_queries(sampled, sub, **kw)
    torch.cuda.synchronize()
    report["sampled_pass_s"] = time.perf_counter() - t0
    report["sampled_locate_lf_walk_launches"] = LAUNCHES["lf_walk"]
    require_launches(LAUNCHES, ("lf_walk",), "sampled locate")
    want = rows[rows[:, 0] < 2 * SAMPLED_READS]
    if not np.array_equal(sorted_rows(res_s), want):
        raise AssertionError("sampled-walk hits differ from the full-SA hits")
    print(f"sampled walk: {len(want)} hits equal on the first {SAMPLED_READS} reads, "
          f"{report['sampled_locate_lf_walk_launches']} lf_walk launches in locate, "
          f"{report['sampled_pass_s'] * 1e3:.1f} ms", flush=True)
    del sampled
    report["hamming"] = hamming_phase(index, ref, queries)
    print(f"hamming: {report['hamming']['hits']} hits on the first {SAMPLED_READS} reads, mismatches recounted",
          flush=True)
    del index

    # K4 and K5 vs plain; then the work-queue path and the fallback
    kernels.append(smem_phase(torch.device("cuda")))
    k4 = kernels[-1]
    print_times(k4)
    print(f"  K1 on the same inputs: device warm {k4['k1_ms_same_inputs']:.4f} / cold "
          f"{k4['k1_cold_ms_same_inputs']:.4f} ms; K4 stages {k4['l2_staging_bytes']} B from L2 a launch "
          f"({k4['launch']}); one warp of positions a CTA: device {k4['staging_ms']:.4f} ms", flush=True)
    index_bi = DeviceIndex.from_host(host)
    step_row, report["workq_queue"] = workq_step_phase(index_bi, queries)
    kernels.append(step_row)
    kernels.append(workq_dedup_phase(index_bi, queries))
    del index_bi, step_row
    for row in kernels:
        print(f"{row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) at {row['shape']}", flush=True)
    index_bi, report["workq"] = workq_path(host, queries, rows)
    report["fallback"], n_queries, n_rows = fallback_phase(index_bi, queries, rows)
    report["sv_e1"] = sv_e1_phase(index_bi, ref)
    report["approx"], k8 = approx_phase(index_bi, queries, rows, tmp.name, fasta, reads)
    # phase mesh: the data mesh, the card listed twice
    report["mesh"] = mesh_phase(host, queries, rows, n_queries, n_rows, ref)
    kernels.append(dict(k8, registers=register_row(ptxas, "frontier", "frontier_kernelILi6ELb1E")))
    print_times(kernels[-1])
    del index_bi
    # each kernel of the sv_e1 path: its figures there beside that path's launches
    e1_path, e1 = report["sv_e1"], report["sv_e1"]["hamming"]["k3h"]
    e1_rows = {
        "workq_step": (e1_path["workq_step"], e1_path["launches"]["workq_step"]),
        "verify": (e1_path["verify"], e1_path["launches"]["verify"]),
        "verify_hamming": (e1, e1_path["hamming"]["verify_launches"]),
    }
    for row in kernels:
        if row["name"] in e1_rows:
            fig, n_launches = e1_rows[row["name"]]
            row.update({f"e1_{key}": val for key, val in fig.items() if key in E1_KEYS}, e1_launches=n_launches)
    print_times(dict(e1, name=f"verify_hamming at the sv_e1 path's {e1['shape']} ({e1['lanes']} lanes a candidate)"))
    print(f"  bound {e1['bound_ms']:.5f} ms by {e1['bound_by']}, plain {e1['plain_ms']:.3f} ms", flush=True)

    # phase cli: the search through the CLI, then the goldens
    report["cli"].update(search=cli_search_phase(tmp.name, fasta, reads, len(queries) // 2, rows, card),
                         goldens=cli_golden_phase(tmp.name))
    # phase sharded: the interval-sharded index of the same reference
    report["sharded"] = sharded_phase(tmp.name, fasta, reads, queries, rows, n_queries, n_rows)
    kernels[0].update(sharded_launches=report["sharded"]["resident_launches"]["rank_all"],
                      swap_launches=report["sharded"]["swap_launches"]["rank_all"])
    # phases interval_mesh (phase sharded's shards on a mesh), multihost (CLI
    # ranks sharing the card) and corpus (the synthetic genome)
    report["interval_mesh"] = interval_mesh_phase(tmp.name, queries, rows)
    report["multihost"] = multihost_phase(tmp.name, fasta, reads)
    report["corpus"] = corpus_phase(tmp.name)

    # phases uni and kmer: exact search through the CLI (K6, K7)
    report["uni"], k6, uni_k7 = uni_phase(tmp.name, fasta, card)
    report["kmer"], kmer_k6, k7 = kmer_phase(tmp.name, fasta, os.path.join(tmp.name, "exact_reads.fasta"), card)
    tmp.cleanup()
    kernels.append(dict(
        name="exact_search", route="cuda", source="sahara_tpu_torch/kernels/csrc/exact.cu",
        replaces="sahara_tpu/engine/exact.py:21", library_ms=None, registers=register_row(ptxas, "exact", "exact_kernel"),
        **k6, kmer_launches=report["kmer"]["launches"]["exact_search"], **{f"kmer_{k}": v for k, v in kmer_k6.items()},
    ))
    kernels.append(dict(
        name="lf_walk", route="cuda", source="sahara_tpu_torch/kernels/csrc/lf_walk.cu",
        replaces="sahara_tpu/engine/locate.py:51", library_ms=None, registers=register_row(ptxas, "lf_walk", "lf_walk"),
        **k7, uni_launches=report["uni"]["sampled_launches"]["lf_walk"], **{f"uni_{k}": v for k, v in uni_k7.items()},
    ))
    for row, other in ((kernels[-2], "kmer"), (kernels[-1], "uni")):
        print_times(row)
        print(f"  at {row['shape']}: plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.5f} ms by "
              f"{row['bound_by']}; at the {other} path's {row[other + '_shape']}: device warm {row[other + '_ms']:.4f} "
              f"/ cold {row[other + '_cold_ms']:.4f} ms, call {row[other + '_call_ms']:.4f} ms, plain "
              f"{row[other + '_plain_ms']:.3f} ms, bound {row[other + '_bound_ms']:.5f} ms by {row[other + '_bound_by']}",
              flush=True)
        print_times(dict({k[len(other) + 1:]: v for k, v in row.items() if k.startswith(other + "_")},
                         name=f"{row['name']} at the {other} path"))
        for pre in ("", other + "_"):
            m, again = row[pre + "model"], row[pre + "ms_again"]
            loads = f"; {m['occ_loads']} occ loads, {m['occ_loads_per_s'] / 1e9:.1f} G/s" if "occ_loads" in m else ""
            print(f"  {row[pre + 'shape']}: warm again {again:.4f} ms; model of the plain run: longest chain "
                  f"{m['longest_chain']} steps, {m['sectors']} distinct 32 B sectors, {m['sector_ms']:.5f} ms at "
                  f"the HBM rate{loads}", flush=True)

    # the rank bench: the path that runs K4
    reset_launches()
    report["rank_bench"] = run_size(SMEM_TEXT_MB, RANK_BENCH_POSITIONS) + run_size(4.6, RANK_BENCH_POSITIONS)
    rank_bench_launches = dict(LAUNCHES)
    require_launches(rank_bench_launches, ("rank_all_smem",), "rank bench")

    path_launches = {**launches, "verify_hamming": report["hamming"]["verify_launches"],
                     "rank_all_smem": rank_bench_launches["rank_all_smem"],
                     "workq_step": report["workq"]["launches"]["workq_step"],
                     "workq_dedup": report["workq"]["launches"]["workq_dedup"],
                     "exact_search": report["uni"]["launches"]["exact_search"],
                     "lf_walk": report["kmer"]["launches"]["lf_walk"],
                     "frontier_step": report["approx"]["launches"]["frontier_step"]}
    for row in kernels:
        row["launches"] = path_launches[row["name"]]
    report.update(card=card, kernels=kernels, total_s=time.perf_counter() - t_start,
                  profiler_sessions=timing.PROFILER_SESSIONS, event_timed=timing.EVENT_TIMED)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(f"total {report['total_s']:.1f} s; {timing.PROFILER_SESSIONS} profiler sessions; kernel times from CUDA "
          f"events where the profiler recorded nothing: {timing.EVENT_TIMED or 'none'}")
    print(card)
    # device times also cold and the call time; K5, K3 and K3h also at the
    # sv_e1 path's shapes, beside that path's launches; K6 also on the kmer
    # path, K7 also on the uni path's sampled walk
    more = ("cold_ms", "call_ms", "sharded_launches", "swap_launches", "pass_ms", "pass_launches")
    more += tuple(f"{p}_{k}" for p in ("e1", "kmer", "uni") for k in (
        "launches", "max_abs_err", "ms", "cold_ms", "call_ms", "plain_ms", "bound_ms", "bound_by"))
    print(json.dumps({"kernels": [{k: row[k] for k in keys + more if k in row} for row in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""`read_simulator` subcommand: simulated reads with planted errors, from a
reference FASTA or uniformly random."""

from __future__ import annotations

from sahara_tpu_torch.io.fasta import read_fasta, write_fasta
from sahara_tpu_torch.sim.read_simulator import random_reads, simulate_reads


def cmd_read_simulator(args):
    if args.input:
        sequences = [rec.seq for rec in read_fasta(args.input)]
        print("loaded fasta file - start simulating")
        records = simulate_reads(
            sequences,
            num_reads=args.number_of_reads,
            read_length=args.read_length,
            sub_errors=args.substitution_errors,
            ins_errors=args.insertion_errors,
            del_errors=args.deletion_errors,
            random_errors=args.errors,
            seed=args.seed,
        )
        write_fasta(args.output, records, line_length=max(args.fasta_line_length, 0))
    else:
        print("no fasta file - start pure random simulating")
        records = random_reads(args.number_of_reads, args.read_length, seed=args.seed)
        write_fasta(args.output, records, line_length=args.fasta_line_length or 80)


def register(subparsers):
    p = subparsers.add_parser("read_simulator", help="simulates reads of a certain length")
    p.add_argument("-i", "--input", default=None, help="path to a fasta file")
    p.add_argument("-o", "--output", required=True, help="path to the output fasta file")
    p.add_argument("--fasta_line_length", type=int, default=80,
                   help="How long should each fasta line be (0: infinite)")
    p.add_argument("-l", "--read_length", type=int, default=150, help="length of the simulated reads")
    p.add_argument("-n", "--number_of_reads", type=int, default=1000, help="number of reads to simulate")
    p.add_argument("--substitution_errors", type=int, default=0, help="number of substitution errors per read")
    p.add_argument("--insertion_errors", type=int, default=0, help="number of insert errors per read")
    p.add_argument("--deletion_errors", type=int, default=0, help="number of deletion errors per read")
    p.add_argument("-e", "--errors", type=int, default=0, help="number of errors (randomly chosen S, I or D)")
    p.add_argument("--seed", type=int, default=0, help="seed to initialize the random generator")
    p.set_defaults(func=cmd_read_simulator)

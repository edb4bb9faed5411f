"""CLI: train the NeRF (counterpart of ``nerfjax/cli/train.py``, with the
same flags plus ``--device``).

    python -m nerfjax_torch.cli.train --cfg_path cfg/blender_scene_tuned.yml

Several cards: one process per card, each started with the same command and
NERFJAX_COORDINATOR (host:port of rank 0), NERFJAX_NUM_PROCESSES and
NERFJAX_PROCESS_ID set, or under torchrun with NERFJAX_DISTRIBUTED=1
(``nerfjax_torch.parallel.init_distributed``; a no-op when none is set).

--fp32 is the reference's no-AMP twin: fp32 compute, dist_last=1e6 and a
global-norm gradient clip of 1.0. --profile_dir writes a torch.profiler
trace (trace.json) of the run and the program's spans (spans.json: the train
step and its stages, the batch feed and the host's waits, each with its start
and end in ns since the epoch, the clock the profiler stamps the card's
events on, its parent, its step and its counts; see ``nerfjax_torch.tracing``).
"""

from __future__ import annotations

from nerfjax_torch.cli._common import cfg_parser, load_cfg


def main() -> None:
    p = cfg_parser("Train NeRF / Instant-NGP on precomputed rays")
    p.add_argument("--fp32", action="store_true", help="fp32 twin (no-AMP ablation)")
    p.add_argument("--resume", action="store_true", help="resume from latest checkpoint")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile_dir", type=str, default=None)
    args = p.parse_args()
    from nerfjax_torch.parallel import init_distributed

    init_distributed(backend="gloo" if args.device == "cpu" else None)
    cfg = load_cfg(args)
    if args.fp32:
        cfg = cfg.merge({"precision": "fp32", "dist_last": 1e6, "grad_clip": 1.0})

    from nerfjax_torch.train import train

    train(cfg, seed=args.seed, resume=args.resume, profile_dir=args.profile_dir, device=args.device)


if __name__ == "__main__":
    main()

"""End-to-end driver: train an EFM on EPIC-compressed egocentric token
streams, sharded over a device mesh, with asynchronous checkpoints and an
injected worker failure mid-run (recovered from the last checkpoint).

The port's counterpart of the reference's ``examples/train_efm.py``
driver, using the port's modules only:

  * EPIC compresses synthetic streams into token sequences, and a
    random-projection hash quantises each token into a discrete vocabulary;
  * a dense transformer is trained next-token on them with the sharded
    train step (``launch.train.jit_train_step``: AdamW, clipping, the
    warmup-cosine schedule) on ``launch.mesh.make_host_mesh()``;
  * ``runtime.fault.FaultTolerantLoop`` checkpoints the sharded state
    (written whole, by rank 0) and a failure injected at 60% of the steps
    restores it;
  * the run fails unless the mean loss of the last ten steps is below that
    of the first ten.

One process per device:

  python -m repro_torch.launch.train_efm [--steps N] [--small] [--device cpu]
  torchrun --nproc-per-node=N -m repro_torch.launch.train_efm [...]

Without ``torchrun`` it runs as a one-rank world.  ``--small`` trains a
2-layer model of width 128 on 8 streams (the full run: 12 layers of width
768 on 48).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core import packing
from repro_torch.core import pipeline as P
from repro_torch.data import synthetic as SYN
from repro_torch.launch import train as TR
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import fault

SEQ, BATCH, SEED = 48, 8, 0


def efm_config(small: bool) -> ModelConfig:
    if small:
        return ModelConfig(
            name="efm-tiny", family="dense", n_layers=2, d_model=128,
            n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
        )
    # ~100M params: 12L x 768 with 8k vocab
    return ModelConfig(
        name="efm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab=8192,
    )


def build_corpus(seed: int, n_streams: int, seq: int, vocab: int,
                 device) -> torch.Tensor:
    """EPIC-compress ``n_streams`` synthetic streams; quantise the token
    features into vocabulary ids.  Returns ``(n_streams, seq)`` int64."""
    scfg = SYN.StreamConfig(n_frames=40, hw=(64, 64), n_obj=5)
    ecfg = P.EPICConfig(frame_hw=(64, 64), patch=16, capacity=seq,
                        tau=0.10, gamma=0.015, theta=8, window=16)
    proj = None
    seqs = []
    for i in range(n_streams):
        s, _ = SYN.generate_stream(np.random.default_rng((seed, i)), scfg,
                                   device=device)
        state, _ = P.compress_stream(s.frames, s.poses, s.gazes, ecfg,
                                     P.EPICModels(), depth_gt=s.depth,
                                     device=device)
        ts = packing.pack_dc_buffer(state.buf, seq, 40.0, 64.0)
        if proj is None:  # random-projection LSH of the token features
            proj = torch.as_tensor(np.random.default_rng(7).standard_normal(
                ts.tokens.shape[-1]).astype(np.float32), device=device)
        h = torch.tanh(ts.tokens @ proj) * 0.5 + 0.5
        ids = torch.clamp((h * (vocab - 1)).long(), 0, vocab - 1)
        seqs.append(torch.where(ts.mask, ids, 0))
    return torch.stack(seqs)


def _device(name):
    if name == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def _ckpt_dir() -> str:
    """A fresh checkpoint directory, the same on every rank."""
    path = [tempfile.mkdtemp(prefix="efm_ckpt_")
            if dist.get_rank() == 0 else None]
    if dist.get_world_size() > 1:
        dist.broadcast_object_list(path, src=0)
    return path[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--streams", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo on the CPU (default: the card)")
    args = ap.parse_args(argv)

    device = _device(args.device)
    mesh = make_host_mesh(device=device)
    rank = dist.get_rank()

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    cfg = efm_config(args.small)
    n_streams = args.streams or (8 if args.small else 48)
    say(f"[1/4] building EPIC-compressed corpus on {device} ...")
    corpus = build_corpus(SEED + 1, n_streams, SEQ, cfg.vocab, device)
    say(f"    corpus: {tuple(corpus.shape)}")

    say("[2/4] init EFM + sharded train step ...")
    model = build_model(cfg, device=device)
    n_params = sum(x.numel() for x in
                   torch.utils._pytree.tree_leaves(model.param_spec()))
    say(f"    {cfg.name}: {n_params / 1e6:.1f}M params on mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    shape = ShapeSpec("example", "train", SEQ, BATCH)
    step_fn, _ = TR.jit_train_step(
        model, mesh, AdamWConfig(lr=3e-4), shape_spec=shape,
        warmup_steps=20, total_steps=args.steps, donate=False,
    )
    params, opt = TR.init_train_state(
        model, torch.Generator(device=device).manual_seed(SEED + 2))

    say("[3/4] training with checkpoints + injected failure ...")
    ckpt_dir = _ckpt_dir()
    injector = fault.FailureInjector([int(args.steps * 0.6)])

    def make_batch(step):
        gen = torch.Generator().manual_seed(10_000 + step)
        idx = torch.randint(0, corpus.shape[0], (BATCH,), generator=gen)
        return {"tokens": corpus[idx.to(device)]}

    losses = []

    def loop_step(state, b):
        p, o, s = state
        injector.maybe_fail(int(s))
        p, o, m = step_fn(p, o, b, s)
        losses.append(float(m["loss"]))
        if s % 50 == 0 or s == args.steps - 1:
            say(f"    step {s:4d} loss {losses[-1]:.4f} "
                f"gnorm {float(m['gnorm']):.3f}")
        return (p, o, s + 1), m

    loop = fault.FaultTolerantLoop(
        fault.LoopConfig(ckpt_dir, ckpt_every=50), loop_step, make_batch,
        device=device)
    t0 = time.time()
    try:
        loop.run((params, opt, 0), args.steps)
    finally:
        loop.saver.wait()
        if rank == 0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    dt = time.time() - t0
    say(f"    {args.steps} steps in {dt:.1f}s ({args.steps / dt:.2f} "
        f"steps/s), restarts={loop.stats.restarts}")

    say("[4/4] final loss curve check ...")
    first = float(np.mean(losses[:10]))
    last = float(np.mean(losses[-10:]))
    say(f"    mean loss first10={first:.4f} last10={last:.4f}")
    if not last < first:
        raise SystemExit("training did not reduce loss")
    say("OK")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())


"""The trained-weights golden files and how their inputs are made.

tests/torch_data/r05_fold1_ema/ carries the JAX package's fold-1 EMA
generator and the JAX package's own outputs with it to a host without
JAX. This module holds their paths and the seeds and settings of their
inputs; tests/test_torch_trained.py writes the files with them (where JAX
is) and holds the port's CPU path against them. The numpy-only functions
that make the inputs, drive a StreamBatcher and compare gradients are
chip_smoke.py's, which reads the files on the GPU (phase 20) with the
seeds they store.

- generator.pt, golden_4s.npz: see tests/test_torch_trained.py.
- golden_stream.npz: two seeded tracks through the JAX package's
  StreamBatcher with SLOTS slots, the second opened OPEN_TICKS[1] ticks
  after the first, at each window of LEFT_CONTEXTS (chunk CHUNK,
  lookahead LOOKAHEAD): `track_<i>`, `open_ticks`, `left_contexts`,
  `chunk`, `lookahead`, and for each window and slot `out_<lc>_<i>`, the
  slot's emitted samples over every tick, the zero chunks that drain its
  lookahead included (untrimmed), and `emitted_<lc>_<i>`, the samples it
  emitted at each of its ticks.
- golden_gstep.npz: one generator step at GSTEP_CUT samples, batch
  GSTEP_BATCH, dropout 0, from the trained generator and a discriminator
  made from `disc_seed` (`seeded_disc`; its leaves' names and shapes are
  stored as `disc_names`, `disc_shapes`); the batch is
  `train_batch(cut_len, batch_seed, batch)`, checked by `batch_sumsq`. It
  stores the loss and its terms (`loss`, `loss_ri`, `loss_mag`,
  `loss_time`, `loss_gan`), every generator parameter's name
  (`grad_names`, in the port's order), its gradient's L2 norm
  (`grad_norms`) and a sketch of it (`grad_sketch`, drawn from
  `sketch_seed`, see `grad_sketch`), and the whole gradient of the leaves
  that the attention backward kernel writes into (`grad:<name>`,
  `ATTENTION_LEAVES`).
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402  (numpy-only helpers, shared with the GPU check)
    grad_sketch, gradient_errors, load_npz as load, seeded_disc, stream_emissions,
    synthetic_track, train_batch,
)

DATA = os.path.join(HERE, "torch_data", "r05_fold1_ema")
GENERATOR = os.path.join(DATA, "generator.pt")
GOLDEN = os.path.join(DATA, "golden_4s.npz")
STREAM = os.path.join(DATA, "golden_stream.npz")
GSTEP = os.path.join(DATA, "golden_gstep.npz")
SR = 16000

# golden_stream.npz: a 3 s and a 2 s track (the files' 2 MB budget), the
# second opened a tick later; windows of 361 frames (dense attention) and
# 601 frames (the attention kernel on the GPU)
STREAM_SECONDS, STREAM_SEEDS, OPEN_TICKS = (3, 2), (21, 22), (0, 1)
SLOTS, CHUNK, LOOKAHEAD = 2, 8000, 4000
LEFT_CONTEXTS = (24000, 48000)

# golden_gstep.npz: 641 frames, the attention kernels' training shape
GSTEP_CUT, GSTEP_BATCH, GSTEP_SEED, DISC_SEED, SKETCH_SEED = 64000, 2, 30, 31, 32
SKETCH = 64
NUM_TSCB = 4
ATTENTION_LEAVES = tuple(f"TSCB_{b}.time_conformer.attn.fn.{leaf}.weight"
                         for b in range(1, NUM_TSCB + 1)
                         for leaf in ("to_q", "to_kv", "rel_pos_emb"))


def stream_tracks():
    return [synthetic_track(s * SR, seed) for s, seed in zip(STREAM_SECONDS, STREAM_SEEDS)]


def run_stream(batcher, tracks, open_ticks, ticks=None):
    """Tracks through a StreamBatcher (the JAX package's or the port's), as
    chip_smoke.stream_emissions drives it; returns each track's emissions."""
    return stream_emissions(batcher, tracks, open_ticks, ticks)[0]


def gstep_batch():
    """The G step's (clean, noisy) [GSTEP_BATCH, GSTEP_CUT] float32 batch."""
    return train_batch(GSTEP_CUT, GSTEP_SEED, GSTEP_BATCH)


def sketch(index: int, g) -> np.ndarray:
    return grad_sketch(index, g, SKETCH_SEED, SKETCH)


def shape_text(shape) -> str:
    return "x".join(str(n) for n in shape)

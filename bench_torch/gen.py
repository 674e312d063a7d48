"""Corpus and pattern panel of a cell, made on the device from the seed.

The benchmark's own copy of the port's core/datagen.generate_text and
generate_patterns, on torch with a seeded generator on the device (a few
large calls on the card, not a host loop), so that later changes to the
port cannot move the yardstick:

  text   n bytes, uniform over [0, sigma) (datagen.generate_text);
  panel  p patterns of length m: round(p * frac_present) windows of the
         text at uniform random starts (they occur), the rest uniform
         random rows (hits only by chance), shuffled
         (datagen.generate_patterns);
  blocks EDIT_BLOCKS blocks of EDIT_ROWS * m bytes: block b is j_b panel
         rows (j_b uniform in [0, EDIT_ROWS]) and then uniform random
         bytes, so blocks add different numbers of matches;
  edits  request i's update of the resident corpus: block b_i written
         over the bytes at start s_i, with the bytes the previous request
         wrote over put back first (request i counts the corpus with that
         one edit).  Drawn on the host, a chunk at a time, from the seed
         and the rank, with every window an edit touches inside one
         rank's own starts and away from its seam.

One seed gives the same bytes on every card of one kind (H100): every rank
of a multi-card cell makes the whole corpus and keeps its shard.
"""

from __future__ import annotations

import torch

#: odd 64-bit constant that spreads a run's seed into its streams
_MIX = 0x9E3779B97F4A7C15
#: the streams of one seed (a rank's edits: EDIT_STREAM + rank, its
#: blocks: BLOCK_STREAM + rank)
TEXT_STREAM, PANEL_STREAM, EDIT_STREAM, BLOCK_STREAM = 1, 2, 16, 1024
#: edits drawn at a time
EDIT_CHUNK = 4096
#: panel rows of an edit's block, and the blocks an edit picks from
EDIT_ROWS = 8
EDIT_BLOCKS = 4096


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed in [0, 2^63) for one stream of a run's seed: any
    whole number, negative or above 2^63 included."""
    return ((int(seed) * _MIX + stream * 0xD1B54A32D192ED03)
            ^ (int(seed) >> 29)) % (1 << 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream_seed(seed, stream))
    return g


def make_text(cfg: dict, seed: int, device) -> torch.Tensor:
    """The config's corpus: (n,) uint8 on `device`."""
    if cfg.get("text", "uniform") != "uniform":
        raise ValueError(f"unknown text kind {cfg['text']!r}")
    g = generator(seed, TEXT_STREAM, device)
    return torch.randint(0, int(cfg["sigma"]), (int(cfg["n"]),),
                         generator=g, dtype=torch.uint8, device=device)


def make_panel(text: torch.Tensor, traffic: dict, sigma: int,
               seed: int) -> torch.Tensor:
    """The traffic's pattern panel over `text`: (p, m) uint8 on text's
    device."""
    p, m = int(traffic["p"]), int(traffic["m"])
    frac = float(traffic.get("frac_present", 0.5))
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"frac_present must be in [0, 1], got {frac}")
    n = int(text.shape[0])
    if n < m:
        raise ValueError("text shorter than pattern length")
    dev = text.device
    g = generator(seed, PANEL_STREAM, dev)
    n_present = int(round(p * frac))
    starts = torch.randint(0, n - m + 1, (n_present,), generator=g,
                           device=dev)
    present = text[starts[:, None] + torch.arange(m, device=dev)]
    rand = torch.randint(0, sigma, (p - n_present, m), generator=g,
                         dtype=torch.uint8, device=dev)
    codes = torch.cat([present, rand])
    return codes[torch.randperm(p, generator=g, device=dev)].contiguous()


def make_blocks(panel: torch.Tensor, sigma: int, seed: int, rank: int
                ) -> torch.Tensor:
    """A rank's edit blocks: (EDIT_BLOCKS, EDIT_ROWS * m) uint8 on the
    panel's device."""
    dev = panel.device
    p, m = int(panel.shape[0]), int(panel.shape[1])
    g = generator(seed, BLOCK_STREAM + rank, dev)
    rows = panel[torch.randint(0, p, (EDIT_BLOCKS, EDIT_ROWS), generator=g,
                               device=dev)]
    filler = torch.randint(0, sigma, rows.shape, generator=g,
                           dtype=torch.uint8, device=dev)
    j = torch.randint(0, EDIT_ROWS + 1, (EDIT_BLOCKS, 1), generator=g,
                      device=dev)
    keep = torch.arange(EDIT_ROWS, device=dev) < j
    return torch.where(keep[..., None], rows, filler).reshape(EDIT_BLOCKS,
                                                              -1)


class Edits:
    """The edits of one rank's requests, in order: edit(i) is (start,
    block) for a corpus (or shard) of n bytes.  A block is width bytes;
    the windows an edit touches, starts start - m + 1 .. start + width - 1,
    lie within [1, n - m - 1].  The same seed, rank and sizes give the
    same edits."""

    def __init__(self, seed: int, rank: int, n: int, m: int):
        self.width = EDIT_ROWS * m
        if n < self.width + 2 * m:
            raise ValueError(f"a corpus of {n} bytes has no room for an "
                             f"edit of {self.width} bytes at m={m}")
        self.g = generator(seed, EDIT_STREAM + rank, "cpu")
        self.lo, self.hi = m, n - self.width - m
        self.starts, self.blocks = [], []

    def __call__(self, i: int):
        while i >= len(self.starts):
            self.starts += torch.randint(self.lo, self.hi + 1, (EDIT_CHUNK,),
                                         generator=self.g).tolist()
            self.blocks += torch.randint(0, EDIT_BLOCKS, (EDIT_CHUNK,),
                                         generator=self.g).tolist()
        return self.starts[i], self.blocks[i]


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    """(text, panel) of one run."""
    text = make_text(cfg, seed, device)
    return text, make_panel(text, traffic, int(cfg["sigma"]), seed)

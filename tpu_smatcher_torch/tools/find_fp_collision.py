"""One-time birthday search for a full fingerprint collision (m=16, DNA);
the port's copy of scripts/find_fp_collision.py.

Finds a difference vector d (entries in [-3, 3], DNA char deltas) with
sum(d_j * mult^j) == 0 mod 2^16 SIMULTANEOUSLY for all three base
fingerprint multipliers (ops/fast.py FP_MULTS[:3]) — i.e. two windows
x and x + d share fp0, fp1 AND fp2, so one passes every derived filter
stage of the other (STAGE_CD keys are affine in the three fps) no matter
how many stages are applied.  The vector found is FP_COLLISION_D below;
collision_case builds the adversarial cell on it, which chip_smoke.py's
conformance phase and the tests share.

Method: meet-in-the-middle over the 48-bit packed (fp0, fp1, fp2) triple —
left half enumerates d[0:9] (7^9 ~ 40M, a few GB of host memory), right
half d[9:16] negated (7^7 ~ 824k), sorted-join on the packed key.

    python -m tpu_smatcher_torch.tools.find_fp_collision
"""

import numpy as np

from tpu_smatcher_torch.ops.fast import FP_MULTS

M16 = (1 << 16) - 1

#: the collision the search finds (scripts/tpu_smoke.py's constant):
#: windows x and x + d share the three base fingerprints
FP_COLLISION_D = np.array([0, 1, 0, -3, 1, 2, -3, 2, 2, -3, 2, 1,
                           -3, 0, 1, 0], np.int64)


def collision_case(n: int = 1 << 21, *, seed: int = 23):
    """The reference smoke's adversarial cell (scripts/tpu_smoke.py): 300
    DNA windows x planted every 96 bytes over a text of n bytes (seed 24),
    and the patterns x + FP_COLLISION_D, none of which occurs there.
    Every x passes every filter stage of its pattern, ~170 false
    candidates per 16,384-start block.  Returns (text, PatternSet)."""
    from tpu_smatcher_torch.core import datagen
    from tpu_smatcher_torch.core.alphabet import Alphabet
    from tpu_smatcher_torch.core.patterns import PatternSet
    d = FP_COLLISION_D
    rng = np.random.default_rng(seed)
    lo, hi = np.maximum(0, -d), np.minimum(3, 3 - d)
    xs = np.stack([rng.integers(lo, hi + 1) for _ in range(300)]
                  ).astype(np.uint8)
    ys = (xs + d[None, :]).astype(np.uint8)
    text = datagen.generate_text(n, Alphabet.dna(), seed=seed + 1).copy()
    for i, s in enumerate(range(0, n - 16, 96)):
        text[s:s + 16] = xs[i % len(xs)]
    return text, PatternSet(ys, Alphabet.dna())


def powers(mult, m):
    out = np.zeros(m, np.int64)
    out[0] = 1
    for i in range(1, m):
        out[i] = (out[i - 1] * mult) & M16
    return out


def collides(d, mults=FP_MULTS[:3]) -> bool:
    """Whether sum(d_j * mult^j) == 0 mod 2^16 for every mult."""
    d = np.asarray(d, np.int64)
    return all(int((d * powers(mu, len(d))).sum()) & M16 == 0
               for mu in mults)


def half_sums(pw0, pw1, pw2, idxs):
    """Packed 48-bit triples of all [-3,3]^len(idxs) combinations."""
    vals = np.array([-3, -2, -1, 0, 1, 2, 3], np.int64)
    f0 = np.zeros(1, np.int64)
    f1 = np.zeros(1, np.int64)
    f2 = np.zeros(1, np.int64)
    combo = np.zeros((1, 0), np.int8)
    for j in idxs:
        f0 = ((f0[:, None] + vals[None, :] * pw0[j]) & M16).reshape(-1)
        f1 = ((f1[:, None] + vals[None, :] * pw1[j]) & M16).reshape(-1)
        f2 = ((f2[:, None] + vals[None, :] * pw2[j]) & M16).reshape(-1)
        combo = np.concatenate(
            [np.repeat(combo, 7, axis=0),
             np.tile(vals.astype(np.int8), combo.shape[0])[:, None]], axis=1)
    key = (f0 << 32) | (f1 << 16) | f2
    return key.astype(np.uint64), combo


def search(m=16, split=9):
    """The first nonzero collision vector of length m, or None."""
    pws = [powers(mu, m) for mu in FP_MULTS[:3]]
    kl, cl = half_sums(*pws, list(range(split)))
    kr, cr = half_sums(*pws, list(range(split, m)))
    # join kl with the field-wise negation of kr: kl + kr == 0 per field
    f0 = (-(kr >> 32).astype(np.int64)) & M16
    f1 = (-((kr >> 16) & np.uint64(M16)).astype(np.int64)) & M16
    f2 = (-(kr & np.uint64(M16)).astype(np.int64)) & M16
    kr2 = ((f0 << 32) | (f1 << 16) | f2).astype(np.uint64)
    order_l = np.argsort(kl)
    order_r = np.argsort(kr2)
    kl_s, kr_s = kl[order_l], kr2[order_r]
    i = np.clip(np.searchsorted(kl_s, kr_s), 0, len(kl_s) - 1)
    nz = np.nonzero(kl_s[i] == kr_s)[0]
    print(f"left {len(kl)} right {len(kr2)} hits {len(nz)}")
    for h in nz[:10]:
        d = np.concatenate([cl[order_l[i[h]]], cr[order_r[h]]]).astype(int)
        if d.any() and collides(d):
            return d
    return None


def main():
    d = search()
    if d is None:
        print("no nonzero collision found — widen the search")
        return 1
    print("d =", list(d))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""EVU stand-in EFM (port of ``repro.core.evu``): a small transformer that
answers the synthetic multiple-choice question "which object was attended
during segment s?" from a compressed token stream (any method's
``packing.TokenStream``).

Accuracy under different compressors at matched memory budgets is the
Table-1 experiment; the probe is trained from a seeded random
initialisation, so nothing is downloaded.

Parameters are a dict of tensors in the reference's layout (linear
weights ``(d_in, d_out)``, a ``"layers"`` list of per-layer dicts), so
``convert.evu_from_jax`` only moves leaves.  The arithmetic follows the
reference where it matters to the last bits: ``jax.nn.gelu``'s tanh form,
the population variance, the ``-1e30`` mask fill, the segment index as a
float32 product truncated to int32 and clipped, and Adam's bias
correction in float32 (``b ** t`` with ``t`` a float32 scalar).  The
attention is a masked einsum, as there.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch import resolve_device
from repro_torch.core.packing import TOKEN_FEAT

Params = Dict[str, Any]


class EVUConfig(NamedTuple):
    d_model: int = 96
    n_heads: int = 4
    n_layers: int = 2
    n_classes: int = 8
    n_segments: int = 8
    lr: float = 3e-3
    steps: int = 400
    batch: int = 32


def _lin(g: torch.Generator, i: int, o: int) -> Tensor:
    return torch.randn((i, o), generator=g, device=g.device) / math.sqrt(i)


def init_params(generator: torch.Generator, cfg: EVUConfig) -> Params:
    """Random parameters drawn from ``generator`` on its device."""
    g = generator
    in_feat = TOKEN_FEAT + cfg.n_segments + 2  # + derived (see _augment)
    p: Params = {
        "in_proj": _lin(g, in_feat, cfg.d_model),
        "seg_embed": 0.02 * torch.randn(
            (cfg.n_segments, cfg.d_model), generator=g, device=g.device
        ),
        "cls": 0.02 * torch.randn((cfg.d_model,), generator=g,
                                  device=g.device),
        "out": _lin(g, cfg.d_model, cfg.n_classes),
        "layers": [],
    }
    d = cfg.d_model
    for _ in range(cfg.n_layers):
        p["layers"].append({
            "wq": _lin(g, d, d),
            "wk": _lin(g, d, d),
            "wv": _lin(g, d, d),
            "wo": _lin(g, d, d),
            "w1": _lin(g, d, 4 * d),
            "w2": _lin(g, 4 * d, d),
        })
    return p


def tree_map(fn, *trees: Params) -> Params:
    """``fn`` over the leaves of parameter dicts of one structure (keys in
    sorted order, as JAX orders them)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(first)}
    if isinstance(first, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def leaves(p: Params):
    """The tensors of a parameter dict, in ``jax.tree.leaves`` order."""
    if isinstance(p, dict):
        for k in sorted(p):
            yield from leaves(p[k])
    elif isinstance(p, list):
        for x in p:
            yield from leaves(x)
    else:
        yield p


def _norm(x: Tensor) -> Tensor:
    mu = x.mean(-1, keepdim=True)
    v = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(v + 1e-5)


THUMB_FEAT = 8 * 8 * 3  # layout of packing.TokenStream features


def _augment(tokens: Tensor, seg: Tensor, cfg: EVUConfig) -> Tensor:
    """Derived features: per-token segment one-hot (from the timestamp
    feature) and a query-match indicator."""

    def seg_of(col):
        t_norm = tokens[..., col]
        return (t_norm * cfg.n_segments).to(torch.int32).clamp(
            0, cfg.n_segments - 1
        )

    seg_id = seg_of(THUMB_FEAT)  # capture time
    seg_last = seg_of(THUMB_FEAT + 5)  # last-use time (EPIC dedup reuse)
    seg_oh = F.one_hot(seg_id.long(), cfg.n_segments).to(torch.float32)
    s = seg[:, None].to(torch.int32)
    match = ((seg_id == s) | (seg_last == s)).to(torch.float32)[..., None]
    gaze = tokens[..., THUMB_FEAT + 3: THUMB_FEAT + 4]
    return torch.cat([tokens, seg_oh, match, match * gaze], dim=-1)


def forward(p: Params, tokens: Tensor, mask: Tensor, seg: Tensor,
            cfg: EVUConfig) -> Tensor:
    """tokens (B, L, F), mask (B, L), seg (B,) -> (B, n_classes)."""
    b, l, _ = tokens.shape
    x = _augment(tokens, seg, cfg) @ p["in_proj"]
    q_tok = (p["cls"] + p["seg_embed"][seg.long()])[:, None, :]  # (B,1,D)
    x = torch.cat([q_tok, x], dim=1)
    m = torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=mask.device),
         mask.to(torch.bool)], dim=1,
    )
    h = cfg.n_heads
    dh = cfg.d_model // h

    def heads(y):
        return y.reshape(b, l + 1, h, dh).permute(0, 2, 1, 3)

    neg = torch.tensor(-1e30, dtype=x.dtype, device=x.device)
    for lp in p["layers"]:
        xn = _norm(x)
        qh, kh, vh = heads(xn @ lp["wq"]), heads(xn @ lp["wk"]), \
            heads(xn @ lp["wv"])
        logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(dh)
        logits = torch.where(m[:, None, None, :], logits, neg)
        a = torch.softmax(logits, -1)
        o = torch.einsum("bhqk,bhkd->bhqd", a, vh)
        o = o.permute(0, 2, 1, 3).reshape(b, l + 1, cfg.d_model)
        x = x + o @ lp["wo"]
        x = x + F.gelu(_norm(x) @ lp["w1"], approximate="tanh") @ lp["w2"]
    return _norm(x[:, 0]) @ p["out"]


def loss_fn(p: Params, batch: Dict[str, Tensor], cfg: EVUConfig) -> Tensor:
    logits = forward(p, batch["tokens"], batch["mask"], batch["seg"], cfg)
    lab = batch["label"].long()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, 1, lab[:, None])[:, 0]
    return (logz - gold).mean()


def grad(p: Params, batch: Dict[str, Tensor], cfg: EVUConfig
         ) -> Tuple[Tensor, Params]:
    """``(loss, d loss / d p)`` with ``p``'s structure."""
    flat = [x.detach().requires_grad_(True) for x in leaves(p)]
    it = iter(flat)
    live = tree_map(lambda _: next(it), p)
    loss = loss_fn(live, batch, cfg)
    gs = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), tree_map(lambda _: next(gs), p)


_B1, _B2 = 0.9, 0.999


def adam_step(p: Params, m: Params, v: Params, i: int,
              batch: Dict[str, Tensor], cfg: EVUConfig
              ) -> Tuple[Params, Params, Params]:
    """One Adam step of :func:`train_eval` on a given batch, ``i`` counting
    from 0."""
    return adam_update(p, m, v, grad(p, batch, cfg)[1], i, cfg)


def adam_update(p: Params, m: Params, v: Params, g: Params, i: int,
                cfg: EVUConfig) -> Tuple[Params, Params, Params]:
    """The reference's Adam update of ``p`` by gradient ``g``, its bias
    correction in float32."""
    dev = next(leaves(p)).device
    m = tree_map(lambda a, b: _B1 * a + (1 - _B1) * b, m, g)
    v = tree_map(lambda a, b: _B2 * a + (1 - _B2) * b * b, v, g)
    t = torch.tensor(i + 1.0, dtype=torch.float32, device=dev)
    c1 = 1 - torch.pow(torch.tensor(_B1, dtype=torch.float32, device=dev), t)
    c2 = 1 - torch.pow(torch.tensor(_B2, dtype=torch.float32, device=dev), t)
    p = tree_map(
        lambda pp, mm, vv: pp - cfg.lr * (mm / c1)
        / (torch.sqrt(vv / c2) + 1e-8),
        p, m, v,
    )
    return p, m, v


def accuracy(p: Params, data: Dict[str, Tensor], cfg: EVUConfig) -> float:
    with torch.no_grad():
        logits = forward(p, data["tokens"], data["mask"], data["seg"], cfg)
        return float(
            (logits.argmax(-1) == data["label"].long()).float().mean()
        )


def train_eval(
    seed: int,
    train: Dict[str, Tensor],
    test: Dict[str, Tensor],
    cfg: EVUConfig,
    device=None,
    *,
    params: Optional[Params] = None,
) -> Tuple[float, Params]:
    """Adam-train the probe on ``train``; return test accuracy and the
    parameters.  ``seed`` seeds one ``torch.Generator`` on ``device``
    (``None``: the card) for the initialisation (unless ``params`` is
    given) and for every batch's indices."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    p = init_params(g, cfg) if params is None else params
    m = tree_map(torch.zeros_like, p)
    v = tree_map(torch.zeros_like, p)
    train = {k: x.to(device) for k, x in train.items()}
    test = {k: x.to(device) for k, x in test.items()}
    n = train["label"].shape[0]
    for i in range(cfg.steps):
        idx = torch.randint(0, n, (cfg.batch,), generator=g, device=device)
        batch = {k: x[idx] for k, x in train.items()}
        p, m, v = adam_step(p, m, v, i, batch, cfg)
    return accuracy(p, test, cfg), p

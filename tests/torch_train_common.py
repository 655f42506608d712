"""Helpers shared by the port's training tests: flattening a parameter tree
by path, and holding parameters after Adam steps against the reference's.

Adam divides each gradient element by its own size (early on an element's
update is about ``lr * g / |g|``), so it turns a gradient element's
*relative* error into an absolute error of up to ``2 * lr`` in its
parameter. The two packages' gradients agree to GRAD_AGREE of each
leaf's largest element (what the gradient tests hold them to), so an
element ``g_i`` of a leaf whose largest is ``G`` carries a relative
error of up to ``rho_i = GRAD_AGREE * G / |g_i|``: nothing for the large
elements, a whole sign for those within float32 noise of zero. Each
parameter element is held to ``tol`` of its leaf's largest value plus
``2 * sum(lr) * min(1, rho_i)`` (``rho_i`` the worst over the steps). With
int8 compression an element whose quantizer input sits within TIE_WINDOW
of a .5 tie, on any rank in any step, may round either way: its
``rho_i`` is 1."""

import numpy as np

# the gradient tests' tolerance: each leaf's gradient within this share of
# its largest element
GRAD_AGREE = 1e-5
# a quantizer input within this many quanta of a .5 tie may round either way:
# the gradients' disagreement, GRAD_AGREE of the largest, in quanta of 1/127 of it
TIE_WINDOW = 127 * GRAD_AGREE


def flat(tree, prefix=""):
    """``{"/a/b": leaf}`` of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def _union(trees, fn, combine):
    out = {}
    for tree in trees:
        for name, v in tree.items():
            m = fn(np.abs(np.asarray(v, np.float64)))
            out[name] = combine(out[name], m) if name in out else m
    return out


def grad_noise(grads) -> dict:
    """Per leaf, ``rho_i`` of the flat gradient trees ``grads`` (one a
    step): the worst over the steps of GRAD_AGREE * G / |g_i|. An element
    whose gradient is exactly zero (an embedding row no token looks up)
    has none: Adam leaves it where weight decay puts it in both
    packages."""
    with np.errstate(divide="ignore"):
        return _union(grads, lambda g: np.where(g > 0, GRAD_AGREE * g.max() / g, 0.0), np.maximum)


def near_tie(xs) -> dict:
    """Per leaf, the elements of the flat quantizer inputs ``xs`` (one tree
    a rank and step) within TIE_WINDOW quanta of a .5 tie in any of them;
    the quantum is ``max|x| / 127``, as ``quantize_int8`` takes it."""

    def tie(x):
        t = x / (x.max() / 127.0 + 1e-12)
        return np.abs(t - np.floor(t) - 0.5) < TIE_WINDOW

    return _union(xs, tie, np.logical_or)


def assert_params_match(got, exp, tol, lrs, rho, ties=None):
    """Every element of ``got``'s leaves (torch) within ``tol`` of the
    largest value of ``exp``'s (numpy) plus ``2 * sum(lrs) * min(1,
    rho)`` (``rho`` a leaf name's array of ``grad_noise``; 1 where
    ``ties`` marks the element)."""
    got = flat(got)
    for name, e in flat(exp).items():
        d = np.abs(got[name].detach().numpy() - e)
        r = np.minimum(rho[name], 1.0)
        if ties is not None:
            r = np.where(ties[name], 1.0, r)
        bound = tol * np.abs(e).max() + 2 * sum(lrs) * r
        worst = np.unravel_index(np.argmax(d - bound), d.shape)
        assert (d <= bound).all(), (name, int((d > bound).sum()), float(d[worst]), float(bound[worst]))

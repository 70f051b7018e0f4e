"""The DS-TCN keyword spotter, its loss and its optimizer.

Feature-last tensors ``(B, T, C)``; parameters are a dict keyed by the
published wekws module names (``preprocessing.out.0``,
``backbone.network.{i}.cnn.{0,1,3,4}``, ``classifier.linear``).

- Linear preprocessing: ``relu(x W^T + b)``.
- DS-TCN block: depthwise conv over ``(K-1) d`` zero frames of left
  context -> BN -> ReLU -> pointwise -> BN -> ReLU -> dropout, plus the
  input; layer i has dilation ``2^i``.
- Head: per-frame linear and sigmoid.
- BN in training: the batch's mean and biased variance over every axis
  but the channels, eps 1e-5.
- Max-pooling loss (wekws): for an utterance's keyword ``-log`` of its
  largest posterior over the valid frames from ``min_duration`` on; for
  every other keyword ``-log(1 - p)`` at its largest; both clamped to
  ``[1e-8, 1]``; the mean over valid rows.
- The optimizer: clipping by global norm (``g * clip / |g|`` where
  ``|g| >= clip``), then Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
  square root, bias-corrected).
"""

from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5


@contextmanager
def arithmetic(precision: str):
    """TF32 on only for ``"tf32"``; restores the flags after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Model:
    """The forward of one configuration's model in training mode.
    ``conf`` is the configuration's ``model`` group (with ``input_dim``
    and ``output_dim``), ``precision`` as the package docstring says."""

    def __init__(self, conf: dict, precision: str = "fp32"):
        self.conf = conf
        self.bconf = conf["backbone"]
        if self.bconf["type"] != "tcn" or not self.bconf.get("ds", False):
            raise ValueError("only the depthwise-separable TCN")
        self.precision = precision
        self.k = self.bconf.get("kernel_size", 8)

    @staticmethod
    def bn(x, p, name):
        mean = x.mean(dim=(0, 1))
        var = ((x - mean) ** 2).mean(dim=(0, 1))
        return (x - mean) * torch.rsqrt(var + BN_EPS) * p[name + ".weight"] \
            + p[name + ".bias"]

    def depthwise(self, x, p, name, dilation):
        w, b = p[name + ".weight"], p[name + ".bias"]
        pad = (self.k - 1) * dilation
        y = F.conv1d(F.pad(x.transpose(1, 2), (pad, 0)), w,
                     dilation=dilation, groups=w.shape[0])
        return y.transpose(1, 2) + b

    @staticmethod
    def pointwise(x, p, name):
        w = p[name + ".weight"][:, :, 0]
        return torch.matmul(x, w.t()) + p[name + ".bias"]

    def ds_tcn_block(self, x, p, name, dilation, dropout):
        y = self.depthwise(x, p, name + ".cnn.0", dilation)
        y = torch.relu(self.bn(y, p, name + ".cnn.1"))
        y = self.pointwise(y, p, name + ".cnn.3")
        y = torch.relu(self.bn(y, p, name + ".cnn.4"))
        if dropout:
            y = F.dropout(y, dropout, training=True)
        return y + x

    @staticmethod
    def _run(block, x, *args):
        """A block; under autograd recomputed in the backward (its input
        kept, its inside not), so that the cell's batch of 6 s rows fits
        beside the program's state.  The recomputation replays the
        block's draws."""
        if torch.is_grad_enabled():
            return checkpoint(block, x, *args, use_reentrant=False)
        return block(x, *args)

    def __call__(self, feats: torch.Tensor, p: Dict[str, torch.Tensor],
                 dropout: float = 0.0) -> torch.Tensor:
        """(B, T, D) features -> (B, T, K) posteriors."""
        lin = "preprocessing.out.0"
        x = torch.relu(torch.matmul(feats, p[lin + ".weight"].t())
                       + p[lin + ".bias"])
        for i in range(self.bconf["num_layers"]):
            x = self._run(self.ds_tcn_block, x, p, f"backbone.network.{i}",
                          2 ** i, dropout)
        head = "classifier.linear"
        return torch.sigmoid(torch.matmul(x, p[head + ".weight"].t())
                             + p[head + ".bias"])


def max_pooling_loss(post: torch.Tensor, target: torch.Tensor,
                     lengths: torch.Tensor, valid: torch.Tensor,
                     min_duration: int) -> torch.Tensor:
    b, t, k = post.shape
    pos = torch.arange(t, device=post.device)[None, :]
    pad = pos >= lengths[:, None]
    early = pad | (pos < min_duration)
    hit = torch.clamp(torch.where(early[:, :, None], 0.0, post).amax(dim=1),
                      1e-8, 1.0)
    miss = torch.clamp(torch.where(pad[:, :, None], 1.0, 1.0 - post)
                       .amin(dim=1), 1e-8, 1.0)
    is_kw = target[:, None] == torch.arange(k, device=post.device)[None]
    loss_b = torch.where(is_kw, -torch.log(hit), -torch.log(miss)).sum(dim=1)
    valid = valid.to(torch.float32)
    return (loss_b * valid).sum() / torch.clamp(valid.sum(), min=1.0)


class Adam:
    """Global-norm clipping, then Adam, over a dict of leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], clip: float,
                 lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.clip, self.lr, self.b1, self.b2, self.eps = clip, lr, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads) -> Dict[str, torch.Tensor]:
        """Updates ``params`` in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = 1.0 if norm < self.clip else float(self.clip / norm)
        self.count += 1
        clipped = {}
        for k, g in grads.items():
            g = g * scale
            clipped[k] = g
            self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g * g
            mu_hat = self.mu[k] / (1 - self.b1 ** self.count)
            nu_hat = self.nu[k] / (1 - self.b2 ** self.count)
            params[k] -= self.lr * mu_hat / (torch.sqrt(nu_hat) + self.eps)
        return clipped


def train_steps(model: Model, features, params: Dict[str, torch.Tensor],
                batches: List[dict], seed: int, train_conf: dict,
                dropout_seed: Optional[int] = None) -> dict:
    """The first ``len(batches)`` optimizer steps from ``params``:
    step i's dither from the step generator of ``(seed, i)``, the
    forward in training mode, the loss, its gradients, clipping and
    Adam.  ``dropout_seed`` seeds the global generator before the first
    step (dropout draws from it).  Returns the losses, the first step's
    clipped gradients and the parameters after the last step (float32,
    every leaf)."""
    from kwsbench.reference.frontend import step_generator

    p = {k: v.detach().clone().to(torch.float32) for k, v in params.items()
         if not k.endswith(("running_mean", "running_var"))}
    opt = Adam(p, train_conf["grad_clip"], train_conf["lr"])
    if dropout_seed is not None:
        torch.manual_seed(dropout_seed)
    losses, grad0 = [], None
    for step, batch in enumerate(batches):
        dev = batch["waves"].device
        gen = step_generator(seed, step, dev)
        with torch.no_grad():
            feats = features(batch["waves"], gen)
        lengths = torch.full((feats.shape[0],), feats.shape[1],
                             device=dev, dtype=torch.int64)
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        with arithmetic(model.precision):
            post = model(feats, leaves,
                         dropout=train_conf.get("dropout", 0.0))
            loss = max_pooling_loss(post, batch["target"].long(), lengths,
                                    batch["valid"],
                                    train_conf["min_duration"])
            loss.backward()
        grads = {k: v.grad for k, v in leaves.items()}
        losses.append(float(loss.detach()))
        del post, loss, leaves
        clipped = opt.step(p, grads)
        if grad0 is None:
            grad0 = clipped
    return {"loss": losses, "grad0": grad0, "params": p}

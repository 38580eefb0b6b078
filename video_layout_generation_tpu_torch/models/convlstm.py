"""ConvLSTM layout predictor (the JAX package's ``models/convlstm.py``), on
NHWC tensors.

The gates are one fused 3x3 conv to 4 * hidden channels, split in the
order i, f, g, o, with the forget gate's +1 bias trick; the time axis is a
Python loop over the context and the rollout. Every conv is the library's
(``models/layers.py``), as the JAX package's are flax convs in XLA; the
decoder is flax's SAME 3x3 stride-2 transposed conv. The carry (h, c) is
kept in the compute dtype, as the JAX package keeps it. Submodules carry
flax's names (``enc``, ``cell.gates``, ``dec``), so ``params_from_flax``
carries a flax tree across unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.one_hot import seg_one_hot
from .layers import Conv, ConvTranspose


class ConvLSTMCell(nn.Module):
    """Peephole-free ConvLSTM cell (Shi et al. 2015) with a fused gate
    conv over the concatenated (x, h)."""

    def __init__(self, cin: int, hidden: int = 64, kernel: int = 3,
                 generator=None):
        super().__init__()
        self.hidden = hidden
        self.gates = Conv(cin + hidden, 4 * hidden, kernel,
                          padding=kernel // 2, generator=generator)

    def forward(self, carry, x: torch.Tensor):
        h, c = carry
        i, f, g, o = self.gates(torch.cat([x, h], -1)).chunk(4, -1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h

    @staticmethod
    def init_carry(batch: int, hw: Tuple[int, int], hidden: int,
                   dtype=torch.float32, device=None):
        shape = (batch, hw[0], hw[1], hidden)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))


class ConvLSTMLayoutPredictor(nn.Module):
    """Encode each context layout (stride-2 conv + ReLU), run the ConvLSTM
    over time at half resolution, decode the next layout's logits (f32).
    ``rollout`` continues autoregressively on its own argmax."""

    def __init__(self, n_classes: int = 20, hidden: int = 64,
                 enc_width: int = 32, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.hidden, self.n_classes = dtype, hidden, n_classes
        self.enc = Conv(n_classes, enc_width, 3, stride=2, padding=1,
                        generator=generator)
        self.cell = ConvLSTMCell(enc_width, hidden, generator=generator)
        self.dec = ConvTranspose(hidden, n_classes, 3, stride=2, padding=0,
                                 crop=1, generator=generator)

    def _encode(self, onehot: torch.Tensor) -> torch.Tensor:
        return F.relu(self.enc(onehot.to(self.dtype or torch.float32)))

    def _decode(self, h: torch.Tensor) -> torch.Tensor:
        return self.dec(h).float()

    def _run_context(self, context_onehots: torch.Tensor):
        n, t, hgt, wdt, _ = context_onehots.shape
        carry = ConvLSTMCell.init_carry(
            n, ((hgt + 1) // 2, (wdt + 1) // 2), self.hidden,
            self.dtype or torch.float32, context_onehots.device)
        for i in range(t):
            carry, _ = self.cell(carry, self._encode(context_onehots[:, i]))
        return carry

    def forward(self, context_onehots: torch.Tensor) -> torch.Tensor:
        """(N, T, H, W, n_classes) -> logits of the next frame, (N, H, W,
        n_classes)."""
        return self._decode(self._run_context(context_onehots)[0])

    def rollout(self, context_onehots: torch.Tensor, n_frames: int
                ) -> torch.Tensor:
        """Continue for ``n_frames``; returns (N, n_frames, H, W) int64 ids."""
        carry = self._run_context(context_onehots)
        outs = []
        for _ in range(n_frames):
            ids = self._decode(carry[0]).argmax(-1)
            outs.append(ids)
            carry, _ = self.cell(carry, self._encode(
                seg_one_hot(ids, self.n_classes)))
        return torch.stack(outs, 1)

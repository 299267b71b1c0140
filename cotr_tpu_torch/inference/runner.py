"""ModelRunner: encode/decode entry points over a loaded model (counterpart
of cotr_tpu/inference/runner.py).

The canvas encode (ResNet + encoder) is separate from the query decode, so
dense passes and refinement encode each canvas once and stream query chunks
through the decoder. The JAX ``lax.scan`` over chunks is a Python loop.
"""

from __future__ import annotations

import numpy as np
import torch

from cotr_tpu_torch.models.cotr import COTRModel
from cotr_tpu_torch.utils.device import resolve_device


class ModelRunner:
    """Holds a model on its device and runs it without autograd.

    ``device``: the card unless the caller asks for the CPU; the model is
    moved there. Inputs may be numpy arrays or tensors; outputs are tensors
    on ``device``."""

    def __init__(self, model: COTRModel, device="cuda",
                 decode_chunk: int = 8192):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.decode_chunk = decode_chunk

    def _as_tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, dtype)

    @torch.inference_mode()
    def encode(self, canvas) -> torch.Tensor:
        """(B, 256, 512, 3) normalized canvas -> (B, 512, d) memory."""
        return self.model.encode(self._as_tensor(canvas))

    @torch.inference_mode()
    def decode(self, memory: torch.Tensor, queries) -> torch.Tensor:
        """(B, 512, d) + (B, Q, 2) -> (B, Q, 2)."""
        return self.model.decode(memory, self._as_tensor(queries))

    @torch.inference_mode()
    def forward(self, canvas, queries) -> torch.Tensor:
        """Full forward (B, 256, 512, 3) + (B, Q, 2) -> (B, Q, 2)."""
        return self.model(self._as_tensor(canvas), self._as_tensor(queries))

    @torch.inference_mode()
    def decode_chunked(self, memory: torch.Tensor, queries) -> torch.Tensor:
        """Decode many queries against cached memory in chunks of
        ``decode_chunk``: Q is padded up to a multiple of the chunk and the
        padding decoded, then discarded (queries are independent, so the
        padding cannot perturb real outputs)."""
        queries = self._as_tensor(queries)
        b, q, _ = queries.shape
        chunk = min(self.decode_chunk, q)
        k = -(-q // chunk)
        pad = k * chunk - q
        if pad:
            queries = torch.cat(
                [queries, queries.new_zeros((b, pad, 2))], dim=1)
        outs = [self.model.decode(memory, queries[:, i * chunk:(i + 1) * chunk])
                for i in range(k)]
        return torch.cat(outs, dim=1)[:, :q]

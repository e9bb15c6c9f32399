"""Image prompts: image content parts → encode worker → prefill.

The counterpart of the JAX package's ``llm/multimodal.py``:

    frontend → preprocessor → [EncodeOperator] → LM worker
                                   │ images
                                   ▼
                              encode worker (ViT on its own card process)

- :func:`extract_images` pulls ``image_url`` content parts out of chat
  messages (``data:`` URLs only) and flattens the rest to text for the
  chat template.
- :class:`LocalVisionEncoder` decodes and resizes the images
  (``llm/image_decode.py``, the port's reader in place of PIL) and runs
  the ViT (``engine/models/vision.py``) on the card, or on the CPU when
  asked.
- :class:`EncodeWorkerHandler` is the encode worker's endpoint: one frame
  of features on the JAX package's wire (base64 of f32 plus ``shape``).
- :class:`EncodeOperator` is the frontend-side stage: it obtains a
  request's features (a local encoder, or the encode worker through a
  client), prepends one placeholder token per feature row to
  ``token_ids`` and attaches the features as ``multimodal``, which the
  engine injects at those positions (``llama.prefill(mm_feats=...)``). An
  image the reader refuses becomes a ``RequestError`` (a 400).
"""

from __future__ import annotations

import asyncio
import base64
from typing import Any, AsyncIterator, List, Optional, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.llm.image_decode import decode_image_data_url
from dynamo_tpu_torch.llm.protocols.openai import RequestError
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.pipeline import Operator

# Placeholder token id at image-feature positions of the prompt: KV blocks
# and usage see ordinary tokens; prefill overrides their embeddings.
IMAGE_PLACEHOLDER_TOKEN = 0


def extract_images(messages: List[dict]) -> Tuple[List[dict], List[str]]:
    """Split image_url parts out of chat messages → (messages with their
    text parts joined into a string, image URLs in order of appearance)."""
    out, urls = [], []
    for msg in messages:
        content = msg.get("content")
        if not isinstance(content, list):
            out.append(msg)
            continue
        texts = []
        for part in content:
            if not isinstance(part, dict):
                continue
            ptype = part.get("type")
            if ptype == "image_url":
                url = (part.get("image_url") or {}).get("url")
                if not url:
                    raise ValueError("image_url part missing url")
                urls.append(url)
            elif ptype in ("text", "input_text"):
                texts.append(part.get("text", ""))
        out.append({**msg, "content": "".join(texts)})
    return out, urls


def features_to_wire(features: np.ndarray) -> dict:
    f = np.ascontiguousarray(features, dtype=np.float32)
    return {"features_b64": base64.b64encode(f.tobytes()).decode(), "shape": list(f.shape)}


def features_from_wire(d: dict) -> np.ndarray:
    raw = base64.b64decode(d["features_b64"])
    return np.frombuffer(raw, dtype=np.float32).reshape(d["shape"]).copy()


class LocalVisionEncoder:
    """The ViT in this process: on ``device`` (the card unless
    ``device="cpu"``; ``cuda`` without a card raises), with ``params`` or
    seeded random weights of ``preset`` (``seed``) in ``dtype``."""

    def __init__(self, config=None, params=None, *, preset: str = "tiny-vit", seed: int = 0, device: str = "cuda",
                 dtype: torch.dtype = torch.bfloat16):
        from dynamo_tpu_torch.engine.engine import resolve_device
        from dynamo_tpu_torch.engine.models import vision

        self.device = resolve_device(device)
        self.config = config or vision.PRESETS[preset]
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = vision.init_params(self.config, gen, device=self.device, dtype=dtype)
        self.params = params
        self._vision = vision

    def encode_urls(self, urls: List[str]) -> np.ndarray:
        """Image URLs → stacked features ``[n_images * P, lm_hidden]`` f32."""
        imgs = np.stack([decode_image_data_url(u, self.config.image_size) for u in urls])
        feats = self._vision.encode(self.params, self.config, torch.from_numpy(imgs).to(self.device))
        return feats.reshape(-1, self.config.lm_hidden_size).cpu().numpy()


class EncodeWorkerHandler:
    """Encode worker endpoint (AsyncEngine shape): request ``{"image_urls":
    [...]}`` → one frame ``{"features_b64", "shape"}``. Serve with
    ``endpoint.serve_endpoint(handler.generate, stats_handler=...)``."""

    def __init__(self, encoder: LocalVisionEncoder):
        self.encoder = encoder
        self.requests_total = 0

    async def generate(self, request: Any, context: Context) -> AsyncIterator[dict]:
        urls = list(request.get("image_urls") or [])
        if not urls:
            raise ValueError("encode request carries no image_urls")
        self.requests_total += 1
        feats = await asyncio.to_thread(self.encoder.encode_urls, urls)
        yield features_to_wire(feats)

    def stats_handler(self) -> dict:
        # The key the JAX package's scrape aggregates (COUNTER_KEYS).
        return {"request_total": self.requests_total}


class EncodeOperator(Operator):
    """Frontend-side stage from image parts to features: ``encoder`` (local)
    or ``client`` (a push router to the encode worker's endpoint), exactly
    one. The preprocessor upstream has put the images in
    ``request["_mm_image_urls"]``."""

    def __init__(self, encoder: Optional[LocalVisionEncoder] = None, client=None):
        if (encoder is None) == (client is None):
            raise ValueError("EncodeOperator needs exactly one of encoder|client")
        self.encoder = encoder
        self.client = client

    async def transform_request(self, request: dict, context: Context) -> dict:
        urls = request.pop("_mm_image_urls", None)
        if not urls:
            return request
        if self.encoder is not None:
            try:
                feats = await asyncio.to_thread(self.encoder.encode_urls, urls)
            except ValueError as e:  # an image the reader refuses: the client's fault
                raise RequestError(str(e)) from None
        else:
            wire = None
            try:
                async for frame in self.client.generate({"image_urls": urls}, context):
                    data = frame.data if hasattr(frame, "data") else frame
                    if isinstance(data, dict) and "features_b64" in data:
                        wire = data
            except RuntimeError as e:
                # The worker's ValueError (a refused image) arrives as its message.
                msg = str(e)
                if msg.startswith("ValueError: "):
                    raise RequestError(msg[len("ValueError: "):]) from None
                raise
            if wire is None:
                raise RuntimeError("encode worker returned no features")
            feats = features_from_wire(wire)
        request = dict(request)
        # One placeholder per feature row, prepended: positions [0, F) carry
        # the image, the text follows.
        request["token_ids"] = [IMAGE_PLACEHOLDER_TOKEN] * feats.shape[0] + list(request.get("token_ids") or [])
        request["multimodal"] = features_to_wire(feats)
        return request

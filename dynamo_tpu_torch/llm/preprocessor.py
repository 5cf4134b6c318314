"""OpenAI preprocessor: chat-template rendering + tokenization + defaults.

Copied from dynamo_tpu/llm/preprocessor.py. A card that brings a chat
template (a checkpoint's tokenizer_config.json or GGUF metadata) is
rendered with jinja2 exactly as the JAX package renders it:
`Environment(keep_trailing_newline=True)`, the `raise_exception` global,
`render(messages=..., add_generation_prompt=True, bos_token="",
eos_token="", tools=request.tools)`. jinja2 is imported only there (it is
a declared requirement of the torch wheel). A card without a template (a
registry model) renders the JAX default template directly in Python, with
the same text.

Image content parts (JAX :29-36, :51-186): each image part becomes an
IMAGE_MARKER in the rendered prompt, the prompt is tokenized segment by
segment around the markers, and each image takes n_patches placeholder ids
(IMAGE_PLACEHOLDER_ID) at the offset its ImagePart records. `_decode_image`
takes a base64 `.npy` data URL or a nested pixel list, resizes to the
tower's image_size by nearest neighbour and scales 0-255 input to [0, 1],
with numpy only. A text-only model refuses image parts.
"""
from __future__ import annotations

import base64
import io
import uuid
from typing import List, Optional, Tuple

import numpy as np

from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.tokenizer import BaseTokenizer
from dynamo_tpu_torch.protocols.common import (
    ImagePart, OutputOptions, PreprocessedRequest, SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionRequest, CompletionRequest, Ext,
)
from dynamo_tpu_torch.protocols.sse import Annotated

ANNOTATION_TOKEN_IDS = "token_ids"
ANNOTATION_FORMATTED_PROMPT = "formatted_prompt"

# literal marking an image's position in the rendered prompt; the prompt is
# split on it and the segments tokenized separately, so no tokenizer ever
# sees the marker
IMAGE_MARKER = "\x00<|dynamo:image|>\x00"
# placeholder id at image-patch positions in token_ids; the engine rewrites
# these to content salts at admission and mixes in the vision embeds, so
# the id never reaches the embedding table
IMAGE_PLACEHOLDER_ID = 0


def render_default_template(messages) -> str:
    """The JAX package's DEFAULT_CHAT_TEMPLATE,
    `{% for message in messages %}<|{{ message.role }}|>{{ message.content
    }}</s>{% endfor %}<|assistant|>`, rendered without jinja2 over the
    {"role", "content"} dicts the template gets."""
    return "".join(f"<|{m['role']}|>{m['content']}</s>"
                   for m in messages) + "<|assistant|>"


def _raise_exception(message):
    raise ValueError(message)


def compile_template(source: str):
    """A chat template compiled as the JAX preprocessor compiles it."""
    import jinja2
    env = jinja2.Environment(keep_trailing_newline=True)
    env.globals["raise_exception"] = _raise_exception
    return env.from_string(source)


class OpenAIPreprocessor:
    def __init__(self, card: ModelDeploymentCard,
                 tokenizer: Optional[BaseTokenizer] = None):
        self.card = card
        self.tokenizer = tokenizer or card.load_tokenizer()
        self._template = None

    @property
    def vision(self):
        """The card's VisionConfig (the card memoizes its config)."""
        return self.card.model_config().vision

    def _render_chat(self, request: ChatCompletionRequest):
        """Render the chat template. Returns (prompt, images): image parts
        become IMAGE_MARKERs in the prompt, and their decoded pixel arrays
        (resized to the tower's image_size) are collected in order."""
        msgs, images = [], []

        def clean(text: str) -> str:
            # user text must never inject the marker: it would misalign
            # the segments and the images in _splice_images
            return text.replace(IMAGE_MARKER, "")

        for m in request.messages:
            content = m.content
            if isinstance(content, list):  # content parts
                pieces = []
                for p in content:
                    if not isinstance(p, dict):
                        continue
                    if p.get("type") in ("image_url", "image"):
                        images.append(self._decode_image(p))
                        pieces.append(IMAGE_MARKER)
                    else:
                        pieces.append(clean(p.get("text", "")))
                content = "".join(pieces)
            elif isinstance(content, str):
                content = clean(content)
            msgs.append({"role": m.role, "content": content or "",
                         **({"name": m.name} if m.name else {})})
        if not self.card.chat_template:
            return render_default_template(msgs), images
        if self._template is None:
            self._template = compile_template(self.card.chat_template)
        return self._template.render(
            messages=msgs, add_generation_prompt=True, bos_token="",
            eos_token="", tools=request.tools), images

    def _decode_image(self, part: dict):
        """An OpenAI image content part -> [S, S, 3] f32 pixels.

        Accepted forms: {"type": "image_url", "image_url": {"url":
        "data:...;base64,<b64 .npy>"}} (base64 of an np.save buffer) and
        {"type": "image", "pixels": <nested lists>}. Pixels are resized to
        the tower's image_size by nearest-neighbour sampling, and input
        past 1.5 is taken as 0-255 and scaled to [0, 1]."""
        vision = self.vision
        if vision is None:
            raise ValueError(
                f"model {self.card.name!r} is text-only; image content "
                "parts are not supported")
        if part.get("type") == "image":
            px = np.asarray(part["pixels"], np.float32)
        else:
            url = (part.get("image_url") or {}).get("url", "")
            if ";base64," not in url:
                raise ValueError(
                    "image_url must be a base64 data URL (remote fetch is "
                    "not supported)")
            raw = base64.b64decode(url.split(";base64,", 1)[1])
            px = np.load(io.BytesIO(raw), allow_pickle=False)
            px = np.asarray(px, np.float32)
        if px.ndim != 3 or px.shape[-1] != 3:
            raise ValueError(f"image pixels must be [H, W, 3], got "
                             f"{px.shape}")
        s = vision.image_size
        if px.shape[:2] != (s, s):
            yi = (np.arange(s) * px.shape[0] // s).clip(0, px.shape[0] - 1)
            xi = (np.arange(s) * px.shape[1] // s).clip(0, px.shape[1] - 1)
            px = px[yi][:, xi]
        if px.max() > 1.5:   # 0-255 input
            px = px / 255.0
        return px

    def _splice_images(self, prompt: str, images: list):
        """Tokenize around the IMAGE_MARKERs, putting n_patches placeholder
        ids in each image's place and recording its token offset."""
        from dynamo_tpu_torch.models.vision import num_patches
        n_patch = num_patches(self.vision)
        segments = prompt.split(IMAGE_MARKER)
        if len(segments) != len(images) + 1:
            # the chat template dropped or repeated a marker: refuse rather
            # than splice embeds at the wrong offsets
            raise ValueError(
                f"image marker count mismatch after template render: "
                f"{len(segments) - 1} markers for {len(images)} images")
        token_ids: List[int] = []
        mm_parts: List[ImagePart] = []
        for i, seg in enumerate(segments):
            if seg:
                token_ids.extend(self.tokenizer.encode(seg))
            if i < len(images):
                px = images[i]
                mm_parts.append(ImagePart(
                    offset=len(token_ids), shape=list(px.shape),
                    dtype="float32", data=px.tobytes()))
                token_ids.extend([IMAGE_PLACEHOLDER_ID] * n_patch)
        return token_ids, mm_parts

    def preprocess_chat(
        self, request: ChatCompletionRequest,
        request_id: Optional[str] = None,
    ) -> Tuple[PreprocessedRequest, List[Annotated]]:
        ext = request.ext or Ext()
        mm_parts = None
        if ext.use_raw_prompt and request.messages:
            prompt = str(request.messages[-1].content or "")
            token_ids = self.tokenizer.encode(prompt)
        else:
            prompt, images = self._render_chat(request)
            if images:
                token_ids, mm_parts = self._splice_images(prompt, images)
            else:
                token_ids = self.tokenizer.encode(prompt)
        pre = self._finish(request, token_ids, request_id)
        if mm_parts:
            pre.mm_parts = mm_parts
        return pre, self._annotations(ext, prompt, token_ids)

    def preprocess_completion(
        self, request: CompletionRequest,
        request_id: Optional[str] = None,
    ) -> Tuple[PreprocessedRequest, List[Annotated]]:
        ext = request.ext or Ext()
        prompt = request.prompt
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            token_ids = list(prompt)
            prompt_text = ""
        else:
            prompt_text = prompt if isinstance(prompt, str) else str(prompt)
            token_ids = self.tokenizer.encode(prompt_text)
        pre = self._finish(request, token_ids, request_id)
        return pre, self._annotations(ext, prompt_text, token_ids)

    def _finish(self, request, token_ids: List[int],
                request_id: Optional[str]) -> PreprocessedRequest:
        ext = request.ext or Ext()
        stop = request.stop
        if isinstance(stop, str):
            stop = [stop]
        max_tokens = getattr(request, "max_completion_tokens", None) \
            or request.max_tokens
        temperature = request.temperature
        if ext.greed_sampling:
            temperature = 0.0
        remaining = self.card.context_length - len(token_ids)
        return PreprocessedRequest(
            request_id=request_id or uuid.uuid4().hex,
            token_ids=token_ids,
            sampling=SamplingOptions(
                temperature=temperature,
                top_p=request.top_p,
                top_k=ext.top_k,
                repetition_penalty=ext.repetition_penalty,
                seed=request.seed,
                n=request.n,
            ),
            stop=StopConditions(
                max_tokens=min(max_tokens, remaining) if max_tokens
                else max(remaining, 1),
                stop=stop,
                ignore_eos=bool(ext.ignore_eos),
            ),
            output=OutputOptions(
                logprobs=self._logprobs_request(request),
                echo=bool(getattr(request, "echo", False)),
            ),
            eos_token_ids=list(self.tokenizer.eos_token_ids),
            model=request.model,
            mdc_sum=self.card.mdcsum,
            annotations=list(ext.annotations or []),
        )

    @staticmethod
    def _logprobs_request(request) -> Optional[int]:
        """OpenAI logprobs knobs -> internal count (None = off). Chat:
        `logprobs: bool` + `top_logprobs: int`; completions: `logprobs:
        int` is the alternative count."""
        lp = request.logprobs
        if isinstance(lp, bool):
            if not lp:
                return None
            return getattr(request, "top_logprobs", None) or 0
        return lp

    @staticmethod
    def _annotations(ext: Ext, prompt: str,
                     token_ids: List[int]) -> List[Annotated]:
        out = []
        wanted = set(ext.annotations or ())
        if ANNOTATION_FORMATTED_PROMPT in wanted:
            out.append(Annotated.annotation(ANNOTATION_FORMATTED_PROMPT,
                                            prompt))
        if ANNOTATION_TOKEN_IDS in wanted:
            out.append(Annotated.annotation(ANNOTATION_TOKEN_IDS, token_ids))
        return out

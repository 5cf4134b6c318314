"""OpenAI preprocessor: chat-template rendering + tokenization + defaults.

Copied from dynamo_tpu/llm/preprocessor.py. A card that brings a chat
template (a checkpoint's tokenizer_config.json or GGUF metadata) is
rendered with jinja2 exactly as the JAX package renders it:
`Environment(keep_trailing_newline=True)`, the `raise_exception` global,
`render(messages=..., add_generation_prompt=True, bos_token="",
eos_token="", tools=request.tools)`. jinja2 is imported only there (it is
a declared requirement of the torch wheel). A card without a template (a
registry model) renders the JAX default template directly in Python, with
the same text. Image content parts come with the vision slice.
"""
from __future__ import annotations

import uuid
from typing import List, Optional, Tuple

from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.tokenizer import BaseTokenizer
from dynamo_tpu_torch.protocols.common import (
    OutputOptions, PreprocessedRequest, SamplingOptions, StopConditions,
)
from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionRequest, CompletionRequest, Ext,
)
from dynamo_tpu_torch.protocols.sse import Annotated

ANNOTATION_TOKEN_IDS = "token_ids"
ANNOTATION_FORMATTED_PROMPT = "formatted_prompt"


def render_default_template(messages) -> str:
    """The JAX package's DEFAULT_CHAT_TEMPLATE,
    `{% for message in messages %}<|{{ message.role }}|>{{ message.content
    }}</s>{% endfor %}<|assistant|>`, rendered without jinja2."""
    return "".join(f"<|{m.role}|>{m.content or ''}</s>"
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

    def _render_chat(self, request: ChatCompletionRequest) -> str:
        for m in request.messages:
            if not (m.content is None or isinstance(m.content, str)):
                raise ValueError("content parts (images) are not supported "
                                 "by this model")
        if not self.card.chat_template:
            return render_default_template(request.messages)
        if self._template is None:
            self._template = compile_template(self.card.chat_template)
        msgs = [{"role": m.role, "content": m.content or "",
                 **({"name": m.name} if m.name else {})}
                for m in request.messages]
        return self._template.render(
            messages=msgs, add_generation_prompt=True, bos_token="",
            eos_token="", tools=request.tools)

    def preprocess_chat(
        self, request: ChatCompletionRequest,
        request_id: Optional[str] = None,
    ) -> Tuple[PreprocessedRequest, List[Annotated]]:
        ext = request.ext or Ext()
        if ext.use_raw_prompt and request.messages:
            prompt = str(request.messages[-1].content or "")
        else:
            prompt = self._render_chat(request)
        token_ids = self.tokenizer.encode(prompt)
        pre = self._finish(request, token_ids, request_id)
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

"""ModelDeploymentCard: serving metadata bundle for a model.

Copied from dynamo_tpu/llm/model_card.py for the slice: cards for registry
models (engine/config.py) with the byte tokenizer. HF-directory and GGUF
cards come with checkpoint loading. The card checksum uses BLAKE2b from the
standard library instead of xxh3.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch.engine.config import ModelConfig, get_model_config
from dynamo_tpu_torch.llm.tokenizer import BaseTokenizer, ByteTokenizer


@dataclasses.dataclass
class ModelDeploymentCard:
    name: str
    model_type: str = "chat"            # "chat" | "completion" | "both"
    arch: str = "tiny"                  # key into the config registry
    tokenizer_kind: str = "byte"
    chat_template: Optional[str] = None  # jinja source, if any
    context_length: int = 2048
    kv_page_size: int = 64
    eos_token_ids: List[int] = dataclasses.field(default_factory=list)
    bos_token_id: Optional[int] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def mdcsum(self) -> str:
        payload = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.blake2b(payload, digest_size=8).hexdigest()

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def model_config(self) -> ModelConfig:
        return get_model_config(self.arch)

    def load_tokenizer(self) -> BaseTokenizer:
        if self.tokenizer_kind != "byte":
            raise NotImplementedError(
                f"tokenizer kind {self.tokenizer_kind!r}: the port serves "
                "registry models with the byte tokenizer")
        return ByteTokenizer()

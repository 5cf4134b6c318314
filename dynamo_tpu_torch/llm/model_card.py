"""ModelDeploymentCard: serving metadata bundle for a model.

Copied from dynamo_tpu/llm/model_card.py: cards for registry models
(engine/config.py, the byte tokenizer), for HF-style checkpoint
directories (`from_hf_dir`: config.json, tokenizer.json, the chat template
of tokenizer_config.json) and for GGUF files (`from_gguf`: config,
tokenizer and chat template from the file's metadata). The card checksum
uses BLAKE2b from the standard library instead of xxh3.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch.engine.config import ModelConfig, get_model_config
from dynamo_tpu_torch.llm.tokenizer import (
    BaseTokenizer, ByteTokenizer, HFTokenizer,
)


@dataclasses.dataclass
class ModelDeploymentCard:
    name: str
    model_type: str = "chat"            # "chat" | "completion" | "both"
    arch: str = "tiny"                  # key into the config registry
    tokenizer_kind: str = "byte"        # "hf" | "gguf" | "byte"
    tokenizer_path: Optional[str] = None
    chat_template: Optional[str] = None  # jinja source, if any
    context_length: int = 2048
    kv_page_size: int = 64
    eos_token_ids: List[int] = dataclasses.field(default_factory=list)
    bos_token_id: Optional[int] = None
    # checkpoint-sourced models: the raw config.json dict (drives
    # ModelConfig) and the checkpoint (drives weight loading)
    hf_config: Optional[Dict[str, Any]] = None
    model_path: Optional[str] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def mdcsum(self) -> str:
        payload = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.blake2b(payload, digest_size=8).hexdigest()

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelDeploymentCard":
        """The card a registry entry carries (its `to_dict` form); fields
        the port's card does not have are left out."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def model_config(self) -> ModelConfig:
        # memoized: the GGUF branch re-opens and walks the file's whole
        # metadata section (vocab and scores arrays included)
        cached = getattr(self, "_model_cfg", None)
        if cached is not None:
            return cached
        if self.tokenizer_kind == "gguf" and self.model_path:
            from dynamo_tpu_torch.llm.gguf import GGUFFile, config_from_gguf
            g = GGUFFile(self.model_path)
            try:
                cfg = config_from_gguf(g, name=self.name)
            finally:
                g.close()
        elif self.hf_config is not None:
            from dynamo_tpu_torch.models.loader import config_from_hf
            cfg = config_from_hf(self.hf_config, name=self.name)
        else:
            cfg = get_model_config(self.arch)
        object.__setattr__(self, "_model_cfg", cfg)
        return cfg

    def load_tokenizer(self) -> BaseTokenizer:
        if self.tokenizer_kind == "hf":
            return HFTokenizer(self.tokenizer_path, self.eos_token_ids,
                               self.bos_token_id)
        if self.tokenizer_kind == "gguf":
            from dynamo_tpu_torch.llm.gguf import GGUFFile, GGUFTokenizer
            g = GGUFFile(self.tokenizer_path or self.model_path)
            try:
                return GGUFTokenizer(g)
            finally:
                g.close()
        if self.tokenizer_kind != "byte":
            raise ValueError(f"unknown tokenizer kind "
                             f"{self.tokenizer_kind!r}")
        return ByteTokenizer()

    @classmethod
    def from_hf_dir(cls, path: str, name: Optional[str] = None,
                    arch: Optional[str] = None) -> "ModelDeploymentCard":
        """A card from an HF-style model directory (config.json +
        tokenizer.json [+ tokenizer_config.json chat_template])."""
        with open(os.path.join(path, "config.json")) as f:
            hf = json.load(f)
        eos = hf.get("eos_token_id", [])
        if isinstance(eos, int):
            eos = [eos]
        chat_template = None
        tok_cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(tok_cfg_path):
            with open(tok_cfg_path) as f:
                tok_cfg = json.load(f)
            chat_template = tok_cfg.get("chat_template")
        tok_json = os.path.join(path, "tokenizer.json")
        if not os.path.exists(tok_json):
            logging.getLogger("dynamo_tpu_torch.model_card").warning(
                "%s has no tokenizer.json; falling back to byte-level "
                "tokenization (text will be garbage for real models)", path)
        return cls(
            name=name or os.path.basename(path.rstrip("/")),
            arch=arch or "tiny",
            # a text-generation checkpoint serves both OpenAI endpoints
            model_type="both",
            tokenizer_kind="hf" if os.path.exists(tok_json) else "byte",
            tokenizer_path=tok_json if os.path.exists(tok_json) else None,
            chat_template=chat_template,
            context_length=int(hf.get("max_position_embeddings", 2048)),
            eos_token_ids=eos,
            bos_token_id=hf.get("bos_token_id"),
            hf_config=hf,
            model_path=path,
        )

    @classmethod
    def from_gguf(cls, path: str,
                  name: Optional[str] = None) -> "ModelDeploymentCard":
        """A card from a single GGUF file: config, tokenizer and chat
        template all come from the embedded metadata."""
        from dynamo_tpu_torch.llm.gguf import GGUFFile, config_from_gguf
        g = GGUFFile(path)
        try:
            cfg = config_from_gguf(g, name=name or "")
            md = g.metadata
            eos = md.get("tokenizer.ggml.eos_token_id")
            return cls(
                name=name or md.get("general.name",
                                    os.path.basename(path)),
                model_type="both",
                tokenizer_kind="gguf",
                chat_template=md.get("tokenizer.chat_template"),
                context_length=cfg.max_model_len,
                eos_token_ids=[int(eos)] if eos is not None else [],
                bos_token_id=md.get("tokenizer.ggml.bos_token_id"),
                model_path=path,
            )
        finally:
            g.close()

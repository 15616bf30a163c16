"""The port's model zoo: the GPT decoder and its weight conversion."""

from unionml_tpu_torch.models.convert import init_gpt, params_from_jax, random_params
from unionml_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel, generate

__all__ = ["GPTConfig", "GPTLMHeadModel", "generate", "init_gpt", "params_from_jax", "random_params"]

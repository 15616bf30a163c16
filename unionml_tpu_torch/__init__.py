"""PyTorch/CUDA port of unionml-tpu: the ``Dataset``/``Model`` app API with
resident serving, GPT paged decode serving, BERT fine-tuning and packed
causal-LM training.

The JAX package (``unionml_tpu``) stays the reference; this package mirrors its
module names so each counterpart is easy to find:

- :class:`Dataset` and :class:`Model` (``dataset``, ``model``, ``stage``,
  ``workflow``, ``checkpoint``): the decorator API. Stages run eagerly or as
  CUDA graphs (``_graphs``); ``Model.serve()`` builds the aiohttp app whose
  ``/predict`` goes through :mod:`unionml_tpu_torch.serving.resident`.

- :mod:`unionml_tpu_torch.ops` — attention (flash forward and backward, with
  packed segment ids), paged attention, classification losses, sequence
  packing, blockwise int8 quantization and token sampling. The attention ops
  run hand-written CUDA kernels (``csrc/``) on CUDA tensors and their plain
  PyTorch versions on CPU tensors.
- :mod:`unionml_tpu_torch.models.gpt` — the GPT-2-style decoder as
  ``nn.Module``s with dense and paged KV caches.
- :mod:`unionml_tpu_torch.models.bert` and
  :mod:`unionml_tpu_torch.models.training` — the BERT classifier and its
  training loop (``create_train_state`` → ``make_classifier_train_step`` →
  ``fit``, ``make_classifier_eval_step``); attention's gradient runs the
  flash-backward kernels through a ``torch.autograd.Function``. Packed
  causal-LM training of the GPT decoder runs through the same module
  (``pack_sequences`` → ``create_train_state`` → ``fit_lm(pack=True)``,
  ``make_lm_eval_step``), with the kernels in their segment-id mode.
- :mod:`unionml_tpu_torch.serving.continuous` — ``DecodeEngine`` (paged int8
  KV pool, bucket and chunked prefill) and the asyncio ``ContinuousBatcher``.

Importing the package loads ``torch`` and ``numpy`` and nothing else heavy:
the models and serving load with their submodules, and the CUDA kernels
build on first launch.
"""

from unionml_tpu_torch.dataset import Dataset
from unionml_tpu_torch.model import BaseHyperparameters, Model, ModelArtifact

__all__ = ["BaseHyperparameters", "Dataset", "Model", "ModelArtifact", "ops", "models", "serving"]

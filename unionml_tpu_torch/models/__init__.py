"""The port's model zoo: the GPT decoder (dense and sparse), the BERT
classifier, the MLP and CNN classifiers, the mixture-of-experts block, their
weight conversion, the training loops (classifier fine-tuning and packed
causal-LM training), and speculative generation.

The JAX package's names are exported too, as aliases where the port's
function has another name: ``gpt_generate``, ``gpt_lm_loss`` and
``init_gpt_cache`` (``models.gpt``'s ``generate``, ``lm_loss``,
``init_cache``), ``import_hf_gpt_weights``, and ``init_gpt_params`` and
``init_params``, the JAX-layout parameter trees of seeded random weights of
GPT and of the BERT classifier (``random_params``, ``bert_random_params``).
"""

from unionml_tpu_torch.models.bert import (
    BertConfig,
    BertForSequenceClassification,
    BertModel,
    import_hf_weights,
    init_bert,
)
from unionml_tpu_torch.models.convert import (
    bert_grads_to_jax,
    bert_params_from_jax,
    bert_random_params,
    cnn_params_from_jax,
    gpt_grads_to_jax,
    init_gpt,
    mlp_params_from_jax,
    params_from_jax,
    random_params,
)
from unionml_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel, generate, lm_loss
from unionml_tpu_torch.models.gpt import generate as gpt_generate
from unionml_tpu_torch.models.gpt import import_hf_weights as import_hf_gpt_weights
from unionml_tpu_torch.models.gpt import init_cache as init_gpt_cache
from unionml_tpu_torch.models.gpt import lm_loss as gpt_lm_loss
from unionml_tpu_torch.models.mlp import CNNClassifier, MLPClassifier
from unionml_tpu_torch.models.moe import MoEMlp, collect_aux_losses, load_balancing_loss, router_z_loss
from unionml_tpu_torch.models.speculative import speculative_generate
from unionml_tpu_torch.models.training import (
    FitResult,
    TrainState,
    bert_flops_per_token,
    create_train_state,
    dict_batches,
    fit,
    fit_lm,
    make_classifier_eval_step,
    make_classifier_train_step,
    make_lm_eval_step,
    make_lm_train_step,
)

init_gpt_params = random_params
init_params = bert_random_params

__all__ = [
    "BertConfig",
    "BertForSequenceClassification",
    "BertModel",
    "CNNClassifier",
    "FitResult",
    "GPTConfig",
    "GPTLMHeadModel",
    "MLPClassifier",
    "MoEMlp",
    "TrainState",
    "bert_flops_per_token",
    "bert_grads_to_jax",
    "bert_params_from_jax",
    "bert_random_params",
    "cnn_params_from_jax",
    "collect_aux_losses",
    "create_train_state",
    "dict_batches",
    "fit",
    "fit_lm",
    "generate",
    "gpt_generate",
    "gpt_grads_to_jax",
    "gpt_lm_loss",
    "import_hf_gpt_weights",
    "import_hf_weights",
    "init_bert",
    "init_gpt",
    "init_gpt_cache",
    "init_gpt_params",
    "init_params",
    "lm_loss",
    "load_balancing_loss",
    "make_classifier_eval_step",
    "make_classifier_train_step",
    "make_lm_eval_step",
    "make_lm_train_step",
    "mlp_params_from_jax",
    "params_from_jax",
    "random_params",
    "router_z_loss",
    "speculative_generate",
]

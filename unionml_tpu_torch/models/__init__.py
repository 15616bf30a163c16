"""The port's model zoo: the GPT decoder (dense and sparse), the BERT
classifier, the MLP and CNN classifiers, the mixture-of-experts block, their
weight conversion, the training loops (classifier fine-tuning and packed
causal-LM training), and speculative generation."""

from unionml_tpu_torch.models.bert import BertConfig, BertForSequenceClassification, import_hf_weights, init_bert
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
from unionml_tpu_torch.models.mlp import CNNClassifier, MLPClassifier
from unionml_tpu_torch.models.moe import MoEMlp, collect_aux_losses
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

__all__ = [
    "BertConfig",
    "BertForSequenceClassification",
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
    "gpt_grads_to_jax",
    "import_hf_weights",
    "init_bert",
    "init_gpt",
    "lm_loss",
    "make_classifier_eval_step",
    "make_classifier_train_step",
    "make_lm_eval_step",
    "make_lm_train_step",
    "mlp_params_from_jax",
    "params_from_jax",
    "random_params",
    "speculative_generate",
]

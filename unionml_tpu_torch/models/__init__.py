"""The port's model zoo: the GPT decoder, the BERT classifier, their weight
conversion, and the classifier training loop."""

from unionml_tpu_torch.models.bert import BertConfig, BertForSequenceClassification, import_hf_weights, init_bert
from unionml_tpu_torch.models.convert import (
    bert_grads_to_jax,
    bert_params_from_jax,
    bert_random_params,
    init_gpt,
    params_from_jax,
    random_params,
)
from unionml_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel, generate
from unionml_tpu_torch.models.training import (
    FitResult,
    TrainState,
    bert_flops_per_token,
    create_train_state,
    dict_batches,
    fit,
    make_classifier_eval_step,
    make_classifier_train_step,
)

__all__ = [
    "BertConfig",
    "BertForSequenceClassification",
    "FitResult",
    "GPTConfig",
    "GPTLMHeadModel",
    "TrainState",
    "bert_flops_per_token",
    "bert_grads_to_jax",
    "bert_params_from_jax",
    "bert_random_params",
    "create_train_state",
    "dict_batches",
    "fit",
    "generate",
    "import_hf_weights",
    "init_bert",
    "init_gpt",
    "make_classifier_eval_step",
    "make_classifier_train_step",
    "params_from_jax",
    "random_params",
]

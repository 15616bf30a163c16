"""Project templates of the PyTorch port and their renderer.

Port of ``unionml_tpu/templates/__init__.py``: each directory here is a
starter app built on :mod:`unionml_tpu_torch`, under the same name as its JAX
counterpart. Rendering is plain ``{{app_name}}`` substitution in paths and
contents, then ``git init`` of the generated app (app versions are git shas).
"""

import subprocess
from pathlib import Path
from typing import List

TEMPLATES_ROOT = Path(__file__).parent

_DESCRIPTIONS = {
    "basic": "digits quickstart: from-scratch softmax regression in torch ops + HTTP serving",
    "jax-digits": "digits MLP (the port's MLPClassifier) trained through fit()",
    "data-parallel": "data-parallel MLP training over every rank of a torch.distributed world (torchrun)",
    "mnist-cnn": "CNN image classifier trained through fit()",
    "bert-finetune": "BERT-base text classification fine-tune with step checkpoints (attention kernels on the card)",
    "torch-digits": "pytorch MLP digits classifier (opaque-trainer path)",
    "keras-mnist": "Keras MNIST CNN (the reference tutorial recipe, opaque path)",
    "gpt-textgen": "character-level GPT text generation with KV-cache decoding",
    "moe-textgen": "sparse (mixture-of-experts) GPT text generation with router aux losses",
    "packed-textgen": "packed-sequence GPT training (fit_lm(pack=True)) + generation",
    "serverless": "sklearn digits behind a FaaS event handler (API-Gateway / storage events)",
    "bentoml-serving": "sklearn digits packaged as a BentoML service (GPU runnable, resident predictor)",
}


def list_templates() -> List[str]:
    return sorted(d.name for d in TEMPLATES_ROOT.iterdir() if d.is_dir() and not d.name.startswith("_"))


def template_description(name: str) -> str:
    return _DESCRIPTIONS.get(name, "")


def _validate_app_name(app_name: str) -> None:
    """Pre-generation guard: the app name must be an importable module name."""
    if not app_name.replace("_", "a").isalnum() or not app_name[0].isalpha():
        raise ValueError(
            f"app name {app_name!r} must be a valid Python identifier (letters, digits, underscores)"
        )


def render_template(name: str, app_name: str, destination: Path) -> Path:
    """Render a template into ``destination/app_name`` and git-init it."""
    _validate_app_name(app_name)
    source = TEMPLATES_ROOT / name
    if not source.is_dir():
        raise ValueError(f"Unknown template {name!r}; available: {list_templates()}")
    target_root = destination / app_name
    if target_root.exists():
        raise FileExistsError(f"{target_root} already exists")

    for path in sorted(source.rglob("*")):
        rel = path.relative_to(source)
        target = target_root / Path(str(rel).replace("{{app_name}}", app_name))
        if path.is_dir():
            target.mkdir(parents=True, exist_ok=True)
        else:
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_text(path.read_text().replace("{{app_name}}", app_name))

    try:
        subprocess.run(["git", "init", "-q"], cwd=target_root, check=True)
        subprocess.run(["git", "add", "-A"], cwd=target_root, check=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        pass  # git unavailable: versioning falls back to an explicit app_version
    return target_root

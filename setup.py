"""Packaging for unionml-tpu.

Reference parity: the console-script pattern of the reference's setup.py
(``unionml = unionml.cli:app``) — here ``unionml-tpu = unionml_tpu.cli:main``, and
``unionml-tpu-torch = unionml_tpu_torch.cli:main`` for the PyTorch port.
"""

from setuptools import find_packages, setup

setup(
    name="unionml-tpu",
    version="0.1.0",
    description="TPU-native ML microservice framework: train, serve, and deploy compiled models",
    packages=find_packages(
        include=["unionml_tpu", "unionml_tpu.*", "unionml_tpu_torch", "unionml_tpu_torch.*"]
    ),
    include_package_data=True,
    # glob semantics skip dotfiles: the scaffold .gitignore files need their own
    # explicit pattern or wheels ship templates without them. The PyTorch
    # port's CUDA and C++ sources build on first use, so they ship as package
    # data, with the port's templates.
    package_data={
        "unionml_tpu": ["templates/**/*", "templates/*/.gitignore"],
        "unionml_tpu_torch": [
            "csrc/*.cu", "csrc/*.cuh", "native/*.cpp", "templates/**/*", "templates/*/.gitignore",
        ],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "pandas",
        "joblib",
        "click",
        "aiohttp",
        "pyyaml",
        "fsspec",
    ],
    extras_require={
        "sklearn": ["scikit-learn"],
        "fastapi": ["fastapi", "uvicorn"],
        "gcs": ["gcsfs"],
        "torch": ["torch"],
    },
    entry_points={
        "console_scripts": [
            "unionml-tpu = unionml_tpu.cli:main",
            "unionml-tpu-torch = unionml_tpu_torch.cli:main",
        ]
    },
)

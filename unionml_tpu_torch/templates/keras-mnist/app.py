"""{{app_name}}: Keras MNIST CNN — the reference's Keras tutorial config, served by the PyTorch port.

Opaque-keras path: the trainer runs keras's own fit loop eagerly; persistence uses the
keras default saver/loader (.keras format). Config mirrors the reference recipe
(batch 512, lr 3e-4).
"""

from typing import Dict, List

import keras
import numpy as np

from unionml_tpu_torch import Dataset, Model

dataset = Dataset(name="{{app_name}}_dataset", test_size=0.2, targets=["labels"])


def build_cnn(learning_rate: float = 3e-4) -> keras.Model:
    net = keras.Sequential(
        [
            keras.layers.Input((28, 28, 1)),
            keras.layers.Conv2D(32, 3, activation="relu"),
            keras.layers.MaxPooling2D(2),
            keras.layers.Conv2D(64, 3, activation="relu"),
            keras.layers.MaxPooling2D(2),
            keras.layers.Flatten(),
            keras.layers.Dense(128, activation="relu"),
            keras.layers.Dense(10),
        ]
    )
    net.compile(
        optimizer=keras.optimizers.Adam(learning_rate),
        loss=keras.losses.SparseCategoricalCrossentropy(from_logits=True),
        metrics=["accuracy"],
    )
    return net


model = Model(name="{{app_name}}", init=build_cnn, dataset=dataset)


@dataset.reader
def reader(n: int = 4096, seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic MNIST-shaped data; swap in keras.datasets.mnist.load_data() online."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    images = (rng.normal(size=(n, 28, 28)) + labels[:, None, None] * 0.15).astype(np.float32)
    return {"images": images, "labels": labels.astype(np.int32)}


@model.trainer
def trainer(
    net: keras.Model,
    features: Dict[str, np.ndarray],
    targets: Dict[str, np.ndarray],
    *,
    batch_size: int = 512,
    epochs: int = 10,
) -> keras.Model:
    net.fit(
        features["images"][..., None],
        targets["labels"],
        batch_size=batch_size,
        epochs=epochs,
        verbose=0,
    )
    return net


@model.predictor
def predictor(net: keras.Model, features: Dict[str, np.ndarray]) -> List[float]:
    logits = net.predict(features["images"][..., None], verbose=0)
    return [float(x) for x in logits.argmax(axis=1)]


@model.evaluator
def evaluator(net: keras.Model, features: Dict[str, np.ndarray], targets: Dict[str, np.ndarray]) -> float:
    _, accuracy = net.evaluate(features["images"][..., None], targets["labels"], verbose=0)
    return float(accuracy)


if __name__ == "__main__":
    net, metrics = model.train(hyperparameters={"learning_rate": 3e-4}, trainer_kwargs={"epochs": 3})
    print(f"metrics: {metrics}")
    model.save("mnist_cnn.keras")

"""Autoencoder — the MNIST MLP autoencoder of the reference zoo
(``bigdl_tpu/models/autoencoder.py``).

``Autoencoder(class_num=32)``: Reshape → Linear(784, class_num) → ReLU →
Linear(class_num, 784) → Sigmoid, trained with ``MSECriterion`` against
its own input. Weights are f32, made on ``device`` (default ``cuda``;
raises without a card unless ``device="cpu"``) from ``generator``
(default: torch's global generator); the child order is the JAX
model's, so :func:`bigdl_tpu_torch.utils.params_tree.load_jax_tree`
carries its weights across.

``train_main`` is the reference's Train main through
:func:`bigdl_tpu_torch.models.utils.run_training` with the JAX main's
defaults (batch 128, ``Adagrad`` at learning rate 0.01, 2 epochs, the
synthetic digits unless ``-f``) and its data: each sample's feature and
target are the digit's raw pixels, flattened.
"""

from __future__ import annotations

from bigdl_tpu_torch.nn import Linear, ReLU, Reshape, Sequential, Sigmoid
from bigdl_tpu_torch.utils.device import resolve_device


def Autoencoder(class_num: int = 32, device=None,
                generator=None) -> Sequential:
    feature_size = 28 * 28
    kw = {"device": resolve_device(device), "generator": generator}
    return (
        Sequential()
        .add(Reshape([feature_size]))
        .add(Linear(feature_size, class_num, **kw))
        .add(ReLU(True))
        .add(Linear(class_num, feature_size, **kw))
        .add(Sigmoid())
    )


def train_main(argv=None):
    """Reference ``models/autoencoder`` Train main (MNIST reconstruction,
    MSE, Adagrad); returns the trained model."""
    import numpy as np

    from bigdl_tpu_torch.dataset.mnist import load_samples
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.models.utils import run_training, train_parser
    from bigdl_tpu_torch.nn.criterion import MSECriterion
    from bigdl_tpu_torch.optim.optim_method import Adagrad

    args = train_parser("Autoencoder on MNIST", batch_size=128,
                        learning_rate=0.01, max_epoch=2).parse_args(argv)
    base = load_samples(args.folder or "/nonexistent", "train",
                        synthetic_count=args.synthetic)
    # reconstruction: the target is the flattened input itself
    samples = [Sample(np.asarray(s.features[0]).reshape(-1),
                      np.asarray(s.features[0]).reshape(-1)) for s in base]
    return run_training(Autoencoder(32, device=args.device), samples,
                        MSECriterion(), args,
                        optim_method=Adagrad(learning_rate=args.learningRate))


if __name__ == "__main__":
    train_main()

"""The port's model zoo: the test fixtures (BoringModule, XORModule,
MNISTClassifier), GPT/Llama with the Hugging Face import, BERT, ViT and
ResNet-18, and the weight bridge from the JAX package's trees
(``models/weights.py``). Importing it imports no ``transformers``: the HF
loaders import it when called."""
from ray_lightning_tpu_torch.models.bert import (
    BERTConfig,
    BERTEncoder,
    apply_mlm_masking,
    bert_forward,
    init_bert_params,
    masked_lm_loss,
)
from ray_lightning_tpu_torch.models.boring import BoringModule, RandomDataset
from ray_lightning_tpu_torch.models.gpt import (
    GPTConfig,
    GPTLM,
    gpt_forward,
    init_gpt_params,
    make_fake_text,
)
from ray_lightning_tpu_torch.models.hf_import import load_hf_gpt2, load_hf_llama
from ray_lightning_tpu_torch.models.mnist import MNISTClassifier, make_fake_mnist
from ray_lightning_tpu_torch.models.resnet import CIFARResNet, make_fake_cifar
from ray_lightning_tpu_torch.models.vit import ViTClassifier, ViTConfig, vit_forward
from ray_lightning_tpu_torch.models.weights import params_from_jax, params_to_numpy
from ray_lightning_tpu_torch.models.xor import XORModule

__all__ = [
    "BoringModule",
    "RandomDataset",
    "XORModule",
    "MNISTClassifier",
    "make_fake_mnist",
    "GPTConfig",
    "GPTLM",
    "CIFARResNet",
    "make_fake_cifar",
    "ViTClassifier",
    "ViTConfig",
    "vit_forward",
    "gpt_forward",
    "init_gpt_params",
    "make_fake_text",
    "load_hf_gpt2",
    "load_hf_llama",
    "BERTConfig",
    "BERTEncoder",
    "bert_forward",
    "init_bert_params",
    "apply_mlm_masking",
    "masked_lm_loss",
    "params_from_jax",
    "params_to_numpy",
]

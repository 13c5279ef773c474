"""The program's models built on the weights of ``weights.py``, and the
inputs the CNN cells share: everything from the seed, on the device."""

from __future__ import annotations

import torch

from bench.lib import seeds, weights


def float32_products() -> None:
    """Products and convolutions in float32, as the configurations state:
    no TF32 in cuBLAS or cuDNN (cuDNN's default would take it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cnn_inputs(config: dict, traffic: dict, seed: int, device):
    """(weights, images, labels): weights drawn from ``seed`` with the
    BatchNorm statistics measured on calibration images, the evaluation
    images, and as labels the float model's top-1 (so the oracle's
    accuracy is the quantized partitions' agreement with the float
    model)."""
    from bench.reference import effnet
    w = weights.draw(weights.cnn_leaves(config), seed, device)
    g = torch.Generator(device=device)
    g.manual_seed(seeds.derive(seed, 19, bits=63))
    hw = config["image_size"]
    calib = torch.randn((traffic["calibration_images"], 3, hw, hw),
                        generator=g, device=device)
    images = torch.randn((traffic["images"], 3, hw, hw), generator=g,
                         device=device)
    with torch.no_grad():
        from bench.reference.precision import precision_of
        with precision_of("float32", images.device):
            effnet.calibrate_bn(w, config, calib)
            labels = effnet.logits(w, config, images).argmax(-1)
    return w, images, labels


def build_cnn(config: dict, w, device):
    """The port's CNN of ``config`` on the weights ``w`` (no copy)."""
    from repro_torch.models.cnn.zoo import build_cnn as zoo_cnn
    float32_products()
    model = zoo_cnn(config["model"]["name"], in_hw=config["image_size"],
                    w=config.get("width", 1.0),
                    n_classes=config["num_classes"])
    model.load_state_dict(w, assign=True)
    return model.eval()

"""Train a reduced EfficientNet-B0 on the synthetic task, quantize it to
4 bits, measure the accuracy drop, and recover with QAT (§IV-C), on
PyTorch.

Weights are drawn from a generator seeded 0 on ``--device``: the card by
default (it raises where there is none), ``cpu`` on the CPU.  The step
updates the model in place (``step(opt_state, x, y)``).

  PYTHONPATH=src python examples/train_qat_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core.quant import QuantSpec
from repro_torch.data import SyntheticImages, batch_iterator
from repro_torch.explore.runner import resolve_device
from repro_torch.models.cnn.zoo import reduced_cnn
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.quantize import qat_finetune, quantized_eval
from repro_torch.training import (evaluate_classifier, init_params,
                                  make_classifier_train_step)


def main(device="cuda", steps=300, qat_steps=80):
    """Train, quantize, fine-tune; returns the float, 4-bit PTQ and 4-bit
    QAT top-1 on 512 held-out images.  Holds the reference test's gates
    (``tests/test_training_serving.py``): quantization does not help, and
    QAT keeps at least the quantized accuracy, less 0.02 and 10 %."""
    dev = resolve_device(device)
    model = reduced_cnn("efficientnet_b0").init_weights(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    ds = SyntheticImages(noise=0.2)
    opt = adamw(warmup_cosine(2e-3, 30, steps))
    opt_state = opt.init(init_params(model))
    step = make_classifier_train_step(model, opt)

    for i in range(steps):
        x, y = ds.batch(64, i)
        opt_state, metrics = step(opt_state, x, y)
        if (i + 1) % 50 == 0:
            print(f"step {i+1}: loss={float(metrics['loss']):.3f} "
                  f"acc={float(metrics['acc']):.3f}")

    vx, vy = ds.eval_set(512)
    acc_fp = evaluate_classifier(model, vx, vy)
    spec = QuantSpec(bits=4)
    acc_q = quantized_eval(model, vx, vy, spec)
    print(f"\nfp32 accuracy:        {acc_fp:.3f}")
    print(f"4-bit PTQ accuracy:   {acc_q:.3f}")

    qat_finetune(model, spec, adamw(5e-4),
                 batch_iterator(ds, 64, start_seed=10_000), steps=qat_steps)
    acc_qat = quantized_eval(model, vx, vy, spec)
    print(f"4-bit QAT accuracy:   {acc_qat:.3f}  "
          f"(recovered {acc_qat - acc_q:+.3f})")
    assert acc_q <= acc_fp + 0.02, (acc_q, acc_fp)
    assert acc_qat >= acc_q - 0.02 and acc_qat >= 0.9 * acc_q, \
        (acc_qat, acc_q)
    return acc_fp, acc_q, acc_qat


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu for tests)")
    main(ap.parse_args().device)

"""Runnable examples of the port, each a module run with ``python -m``:
``torch_ddp`` (a DDP pipeline with the sampler swapped in), ``training``
(training on the card from device-resident indices) and
``imagenet_resnet`` (the ImageNet-1k index space, a checkpointed training
slice and a ViT).  Each runs on the card and takes ``--cpu`` to run on the
host instead."""

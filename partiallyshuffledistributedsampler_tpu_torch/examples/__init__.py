"""Runnable examples of the port, each a module run with ``python -m``:
``torch_ddp`` (a DDP pipeline with the sampler swapped in), ``training``
(training on the card from device-resident indices) and
``imagenet_resnet`` (the ImageNet-1k index space, a checkpointed training
slice and a ViT), ``llama3_10b_index`` (the 10B-sample index space by
random access, a rank's whole epoch, reseeds and the pretrain mixture) and
``webdataset_shards`` (the shard-index stream of tar shards, expanded on
the card), ``index_service`` (a daemon that regenerates on the card feeding
served loaders, then a crash and a restart from its snapshot) and
``multi_tenant`` (one daemon hosting two jobs: namespaces, admission
quotas, the fair-share regen queue).  Each runs on the card and takes ``--cpu`` to run on the host
instead."""

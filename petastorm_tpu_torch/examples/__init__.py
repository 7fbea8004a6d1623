"""The port's examples, each a module with its own schema and store
generator (the repo's ``examples/`` import the JAX package):

    python -m petastorm_tpu_torch.examples.mnist --generate
    python -m petastorm_tpu_torch.examples.imagenet --generate --augment
    python -m petastorm_tpu_torch.examples.long_context --generate
    python -m petastorm_tpu_torch.examples.preemptible

They run on the card by default (``--device cpu`` for a look on the host).
"""

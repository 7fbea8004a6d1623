"""SGD training steps (counterparts of ``petastorm_tpu/models/train.py:34-61, 102-185``
and of the LM step body in ``bench.py:216-240``).

``optax.sgd(lr, momentum)`` keeps ``t = g + momentum * t`` and steps
``-lr * t``; ``torch.optim.SGD(momentum=, dampening=0)`` is the same
update, so one step of either moves the same params. Batch statistics
update inside the train-mode forward, as flax's ``mutable=['batch_stats']``
does. The scan (microbatched) trainer and the mesh paths come later.
"""

import torch
import torch.nn.functional as F


class TrainState(object):
    """The model and its optimizer (the counterpart of flax's TrainState)."""

    def __init__(self, model, optimizer):
        self.model = model
        self.optimizer = optimizer
        self.step = 0


def create_train_state(model, learning_rate=1e-3, momentum=0.9):
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=learning_rate,
                                             momentum=momentum))


def make_train_step():
    """``step(state, images, labels) -> {'loss', 'accuracy'}`` (0-d
    tensors, not synchronised): integer-label softmax cross entropy."""

    def train_step(state, images, labels):
        state.model.train()
        logits = state.model(images)
        loss = F.cross_entropy(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            accuracy = (logits.argmax(-1) == labels).float().mean()
        return {'loss': loss.detach(), 'accuracy': accuracy}

    return train_step


def make_lm_train_step():
    """``step(state, tokens) -> {'loss'}`` for a language model: ``tokens``
    is ``[B, T + 1]`` integer, the inputs ``tokens[:, :-1]`` predict
    ``tokens[:, 1:]``, the loss is the mean softmax cross entropy over
    ``[B, T, vocab]`` f32 logits (the non-MoE body of ``bench.py:216-240``,
    one step per call). The loss is a 0-d tensor, not synchronised."""

    def train_step(state, tokens):
        state.model.train()
        x, y = tokens[:, :-1], tokens[:, 1:]
        logits = state.model(x)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {'loss': loss.detach()}

    return train_step

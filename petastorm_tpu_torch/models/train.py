"""SGD training steps (counterparts of ``petastorm_tpu/models/train.py:34-61, 102-197``
and of the LM step body in ``bench.py:216-244``).

``optax.sgd(lr, momentum)`` keeps ``t = g + momentum * t`` and steps
``-lr * t``; ``torch.optim.SGD(momentum=, dampening=0)`` is the same
update, so one step of either moves the same params. Batch statistics
update inside the train-mode forward, as flax's ``mutable=['batch_stats']``
does.

The scan trainers run K sequential SGD steps per call over a superbatch of
K microbatches, as ``jax.jit(lax.scan(...))`` does: microbatch i+1 sees the
params microbatch i updated. PyTorch's counterpart of the K-step loop
compiled into one program is a CUDA graph of the K-step body, captured
once and replayed (:class:`ScanStep`); on the CPU the same body runs
eagerly.

On a mesh (``create_train_state(mesh=...)``, one process per GPU) the
state's parameters are this rank's shards (:func:`_param_spec`,
:func:`transformer_param_spec`, ``moe.expert_param_spec``,
``pipeline.pipeline_param_spec``), each rank computes on its tile of the
batch, and its loss is the mean over its tile (the ranks' losses average
to the JAX step's loss). The gradients are averaged over the axes the
batch is split over (``sync_gradients``: one flattened ``all_reduce`` a
group of axes) before the optimizer steps, inside a scan step's CUDA graph
too; the metrics are the global ones.
"""

import torch
import torch.nn.functional as F

from petastorm_tpu_torch.models.moe import moe_aux_loss
from petastorm_tpu_torch.parallel.collectives import all_gather_plain
from petastorm_tpu_torch.parallel.mesh import (axis_group, axis_index, axis_names, axis_size,
                                               has_axis)
from petastorm_tpu_torch.parallel.tensor_parallel import (mean_over, shard_parameters,
                                                          sync_gradients)


class TrainState(object):
    """The model and its optimizer (the counterpart of flax's TrainState);
    on a mesh also the mesh, the placements of the split parameters
    (``{name: (spec, global_shape)}``), the axes the batch is split over
    (``batch_axes``) and those the gradients are averaged over
    (``data_axes``: the batch's, the sequence's and the experts')."""

    def __init__(self, model, optimizer, mesh=None, placements=None, batch_axes=(),
                 data_axes=()):
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        self.placements = dict(placements or {})
        self.batch_axes = tuple(batch_axes)
        self.data_axes = tuple(data_axes)
        self.step = 0


def _param_spec(name, param, mesh, module=None):
    """The classifier head by column over ``'model'`` (``train.py:23-31``;
    its ``[out, in]`` weight on dim 0, its bias with it), everything else
    whole. A head whose classes do not divide stays whole."""
    del module
    if mesh is None or not has_axis(mesh, 'model'):
        return None
    if name in ('head.weight', 'head.bias') and param.shape[0] % axis_size(mesh, 'model') == 0:
        return ('model',) + (None,) * (param.ndim - 1)
    return None


def transformer_param_spec(name, param, mesh, module=None):
    """Megatron tensor parallelism of :class:`~.transformer.TransformerLM`
    over ``'model'`` (``train.py:64-99``), in the port's ``[out, in]``
    layout: q/k/v by head and ``out`` by its head input, ``mlp_in``
    (flax ``Dense_0``) by column and ``mlp_out`` (``Dense_1``) by row, the
    head by vocabulary. A column-split layer's bias splits with it; a
    row-split layer's bias stays whole (it is added after the sum). A
    layer whose split does not divide (heads, ``4 d`` or vocabulary) stays
    whole, as ``fits()`` leaves the leaf replicated."""
    if mesh is None or not has_axis(mesh, 'model'):
        return None
    n = axis_size(mesh, 'model')
    *path, owner, leaf = name.split('.')
    column = (('model', None) if leaf == 'weight' else ('model',))
    if path[-1:] == ['attn'] and owner in ('query', 'key', 'value'):
        return column if module.heads % n == 0 else None
    if path[-1:] == ['attn'] and owner == 'out':
        return (None, 'model') if leaf == 'weight' and module.heads % n == 0 else None
    if owner == 'mlp_in' and param.shape[0] % n == 0:
        return column
    if owner == 'mlp_out' and leaf == 'weight' and param.shape[1] % n == 0:
        return (None, 'model')
    if not path and owner == 'head' and param.shape[0] % n == 0:
        return column
    return None


def create_train_state(model, learning_rate=1e-3, momentum=0.9, mesh=None, param_spec_fn=None,
                       batch_axis='data', make_optimizer=None):
    """The model and an SGD optimizer (``optax.sgd(lr, momentum)``), or
    ``make_optimizer(params)``'s (the counterpart of ``tx=``), made over the
    parameters as this rank holds them.

    With a ``mesh`` (``train.py:34-61``): ``param_spec_fn(name, param, mesh,
    module)`` (default :func:`_param_spec`) splits the parameters, each rank
    keeping its shard of the model's current (global) values, so build the
    model from one seed or one flax tree on every rank first; BatchNorm
    takes the statistics of the batch of every rank of ``batch_axis``.
    """
    placements, batch_axes, data_axes = {}, (), ()
    if mesh is not None:
        placements = shard_parameters(model, mesh, param_spec_fn or _param_spec)
        batch_axes = tuple(a for a in axis_names(batch_axis) if has_axis(mesh, a))
        extra = tuple(a for a in (getattr(model, 'seq_axis', None),
                                  getattr(model, 'expert_axis', None))
                      if a is not None and has_axis(mesh, a) and a not in batch_axes)
        data_axes = batch_axes + extra
        if axis_size(mesh, batch_axes) > 1:
            from petastorm_tpu_torch.models.resnet import BatchNorm
            for module in model.modules():
                if isinstance(module, BatchNorm):
                    module.sync_group = axis_group(mesh, batch_axes)
                    module.sync_size = axis_size(mesh, batch_axes)
    if make_optimizer is None:
        optimizer = torch.optim.SGD(model.parameters(), lr=learning_rate, momentum=momentum)
    else:
        optimizer = make_optimizer(model.parameters())
    return TrainState(model, optimizer, mesh, placements, batch_axes, data_axes)


def _check_mesh(state, mesh, batch_axis):
    """A step made for ``mesh`` runs only on a state of that mesh, created
    with the same ``batch_axis``."""
    if mesh is None:
        return
    if state.mesh is not mesh:
        raise ValueError('the step was made for another mesh than the state was created on')
    if tuple(a for a in axis_names(batch_axis) if has_axis(mesh, a)) != state.batch_axes:
        raise ValueError('the step splits the batch over {}, the state over {}'.format(
            batch_axis, state.batch_axes))


def _sgd(state, loss):
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if state.mesh is not None:
        sync_gradients(state.model, state.mesh, state.data_axes, state.placements)
    state.optimizer.step()


def _global(state, value):
    """The global value of a metric from this rank's tile mean of it."""
    return mean_over(value, state.mesh, state.data_axes) if state.mesh is not None else value


def _classifier_step(state, images, labels):
    """One SGD step of integer-label softmax cross entropy: ``(loss,
    accuracy)``, 0-d tensors, no host synchronisation. The body that
    :func:`make_train_step` and :func:`make_scan_train_step` share, as
    ``make_train_step_fn`` is shared in the JAX package."""
    state.model.train()
    logits = state.model(images)
    loss = F.cross_entropy(logits, labels)
    _sgd(state, loss)
    with torch.no_grad():
        accuracy = (logits.argmax(-1) == labels).float().mean()
    return _global(state, loss.detach()), _global(state, accuracy)


#: The weight of the Switch load-balance loss in the LM loss (``bench.py:223-233``).
MOE_AUX_WEIGHT = 1e-2


def _lm_step(state, tokens):
    """One SGD step of next-token cross entropy over ``[B, T + 1]`` tokens
    (the body of ``bench.py:216-244``): ``(loss,)``, or ``(loss, aux)`` for
    a model with :class:`~.moe.SwitchMoE` layers, whose loss is then
    ``ce + 1e-2 * aux`` (``aux`` summed over the layers, as the bench sums
    the sown intermediates)."""
    state.model.train()
    if getattr(state.model, 'seq_axis', None) is not None:
        loss = _sequence_parallel_ce(state, tokens)
    else:
        x, y = tokens[:, :-1], tokens[:, 1:]
        logits = state.model(x)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())
    aux = moe_aux_loss(state.model)
    if aux is not None:
        loss = loss + MOE_AUX_WEIGHT * aux
    _sgd(state, loss)
    loss = _global(state, loss.detach())
    return (loss,) if aux is None else (loss, aux.detach())


def _sequence_parallel_ce(state, tokens):
    """This rank's next-token loss over ``[B, T]`` tokens of which it holds
    the ``[B/dp, T/sp]`` tile: the target of position ``t`` is token
    ``t + 1`` of the whole sequence (it may sit on the next rank), and the
    last position has none (the loss of the JAX package's sequence-parallel
    LM, ``__graft_entry__.py:306-311``). Its sum is divided by the mean
    count of a rank's targets, so the ranks' losses average to the global
    mean."""
    model, mesh = state.model, state.mesh
    group = axis_group(mesh, model.seq_axis)
    b, t = tokens.shape
    sp, me = axis_size(mesh, model.seq_axis), axis_index(mesh, model.seq_axis)
    whole = all_gather_plain(tokens, group).permute(1, 0, 2).reshape(b, sp * t)
    targets = torch.roll(whole, -1, 1)[:, me * t:(me + 1) * t]
    valid = (me * t + torch.arange(t, device=tokens.device)) < sp * t - 1
    logits = model(tokens)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long(),
                         reduction='none').reshape(b, t)
    return (ce * valid).sum() * sp / (b * (sp * t - 1))


def make_train_step(mesh=None, batch_axis='data'):
    """``step(state, images, labels) -> {'loss', 'accuracy'}`` (0-d
    tensors, not synchronised): integer-label softmax cross entropy. On a
    mesh the inputs are this rank's tile and the metrics the global batch's;
    ``mesh`` (if given) must be the state's, whose ``batch_axis`` it was
    created with."""
    def train_step(state, images, labels):
        _check_mesh(state, mesh, batch_axis)
        loss, accuracy = _classifier_step(state, images, labels)
        state.step += 1
        return {'loss': loss, 'accuracy': accuracy}

    return train_step


def _lm_metrics(loss, aux=None):
    return {'loss': loss} if aux is None else {'loss': loss, 'aux_loss': aux}


def make_lm_train_step(mesh=None, batch_axis='data'):
    """``step(state, tokens) -> {'loss'}`` for a language model: ``tokens``
    is ``[B, T + 1]`` integer, the inputs ``tokens[:, :-1]`` predict
    ``tokens[:, 1:]``, the loss is the mean softmax cross entropy over
    ``[B, T, vocab]`` f32 logits (the body of ``bench.py:216-244``, one
    step per call). A model with experts adds ``1e-2 * aux`` to the loss
    and returns ``'aux_loss'`` too. 0-d tensors, not synchronised.

    A sequence-parallel model (``seq_axis``) takes this rank's ``[B/dp,
    T/sp]`` tile of ``[B, T]`` tokens instead, each position predicting the
    next token of the whole sequence and the last predicting none."""
    def train_step(state, tokens):
        _check_mesh(state, mesh, batch_axis)
        metrics = _lm_metrics(*_lm_step(state, tokens))
        state.step += 1
        return metrics

    return train_step


def make_eval_step():
    """``eval_step(state, images, labels) -> {'loss', 'accuracy'}``: the
    eval-mode forward (running batch statistics) under ``no_grad``
    (``petastorm_tpu/models/train.py:188-197``)."""

    def eval_step(state, images, labels):
        state.model.eval()
        with torch.no_grad():
            logits = state.model(images)
            return {'loss': F.cross_entropy(logits, labels),
                    'accuracy': (logits.argmax(-1) == labels).float().mean()}

    return eval_step


def _optimizer_view(optimizer):
    """What a captured graph holds fixed of ``optimizer``: each group's
    hyperparameters (Python values, baked into the captured kernels'
    arguments) and the addresses of its params and of their state tensors
    (the momentum buffers the graph reads and writes)."""

    def fixed(value):
        return ('tensor', value.data_ptr()) if torch.is_tensor(value) else value

    view = []
    for group in optimizer.param_groups:
        view.append(sorted((key, fixed(value)) for key, value in group.items() if key != 'params'))
        view.extend((p.data_ptr(), sorted((key, fixed(value))
                                          for key, value in optimizer.state.get(p, {}).items()))
                    for p in group['params'])
    return view


class ScanStep(object):
    """K sequential SGD steps a call over superbatches of K microbatches.

    ``step(state, *inputs)``: each input's leading dim is K microbatches
    of equal size (``ValueError`` if K does not divide it); ``body(state,
    *microbatch_inputs)`` returns a tuple of 0-d metric tensors, stacked
    into ``[K]`` tensors for ``finish``, which maps them to the result
    dict. ``state.step`` advances by K.

    On CPU tensors the K steps run eagerly. On CUDA tensors:

    - the first call runs the K steps eagerly on the step's own side
      stream: a real training call that also creates the optimizer's
      momentum buffers, runs cuDNN's autotuning and compiles the Triton
      kernel ahead of capture;
    - the second call copies its inputs into static buffers, captures the
      K-step body once into a ``torch.cuda.CUDAGraph`` (on the same side
      stream; autograd, the gradients and the optimizer's update included)
      and replays it;
    - every later call copies its superbatch into the static buffers and
      replays the graph, on the caller's stream.

    ``replays`` counts the replays. The captured graph is kept beside its
    executable one (``keep_graph=True``), so its kernel nodes can be read
    (:func:`petastorm_tpu_torch.bench.graph_kernels`).

    A capture or replay that fails raises; nothing falls back to eager
    execution. The graph replays what it captured: the state, the input
    shapes and types, the optimizer's hyperparameters (``lr``,
    ``momentum``, ...) and the addresses of the params and of the
    optimizer's state. Before each replay the step checks them and raises
    ``ValueError`` if any changed (another state, a new learning rate,
    ``optimizer.load_state_dict`` with new buffers): make a new step then.
    A ``generator`` the body draws from is registered with the graph
    before capture: each replay then draws from its current state and
    advances it, as an eager call would. Capture refuses a draw from any
    other generator but the device's default one, so an unregistered
    generator raises; nothing replays a captured draw. Results are cloned
    out of the graph's output tensors, so a caller's metrics of one call
    are not overwritten by the next. Capture runs in
    the ``thread_local`` error mode, so a loader's staging threads may keep
    allocating and copying on their own streams meanwhile.
    """

    def __init__(self, body, finish, microbatches, generator=None):
        if microbatches < 1:
            raise ValueError('microbatches must be >= 1, got {}'.format(microbatches))
        self._body = body
        self._finish = finish
        self._generator = generator
        self.microbatches = int(microbatches)
        self.calls = 0
        self.replays = 0
        self.graph = None
        self._stream = None
        self._state = None
        self._static_inputs = None
        self._static_out = None
        self._optimizer_view = None

    def _run(self, state, inputs):
        k = self.microbatches
        micro = inputs[0].shape[0] // k
        metrics = [self._body(state, *(x[i * micro:(i + 1) * micro] for x in inputs))
                   for i in range(k)]
        return self._finish(*(torch.stack(column) for column in zip(*metrics)))

    def _check(self, state, inputs):
        total = inputs[0].shape[0]
        if total % self.microbatches or any(x.shape[0] != total for x in inputs):
            raise ValueError('superbatch {} not divisible by microbatches {}'.format(
                [tuple(x.shape) for x in inputs], self.microbatches))
        if self._state is not None and state is not self._state:
            raise ValueError('this scan step was captured for another TrainState; '
                             'make a new step for each state')
        if self._static_inputs is not None:
            for got, want in zip(inputs, self._static_inputs):
                if (got.shape, got.dtype, got.device) != (want.shape, want.dtype, want.device):
                    raise ValueError('the CUDA graph was captured for {} {} on {}, got {} {} on '
                                     '{}'.format(tuple(want.shape), want.dtype, want.device,
                                                 tuple(got.shape), got.dtype, got.device))
        if self.graph is not None and _optimizer_view(state.optimizer) != self._optimizer_view:
            raise ValueError('the optimizer changed since the CUDA graph was captured (its '
                             'hyperparameters, or the tensors of its params or state); the '
                             'graph would replay the old ones: make a new step')

    def __call__(self, state, *inputs):
        self._check(state, inputs)
        if inputs[0].device.type != 'cuda':
            out = self._run(state, inputs)
        elif self.calls == 0:
            out = self._warm_up(state, inputs)
        else:
            if self.graph is None:
                self._capture(state, inputs)
            for static, x in zip(self._static_inputs, inputs):
                static.copy_(x)
            self.graph.replay()
            self.replays += 1
            out = {name: value.clone() for name, value in self._static_out.items()}
        self.calls += 1
        state.step += self.microbatches
        return out

    def _warm_up(self, state, inputs):
        self._state = state
        self._stream = torch.cuda.Stream(inputs[0].device)
        caller = torch.cuda.current_stream(inputs[0].device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            out = self._run(state, inputs)
        caller.wait_stream(self._stream)
        for x in inputs:
            x.record_stream(self._stream)
        return {name: value.clone() for name, value in out.items()}

    def _capture(self, state, inputs):
        self._static_inputs = [torch.empty_like(x) for x in inputs]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if self._generator is not None:
            with torch.cuda.device(inputs[0].device):
                # A replay then reads the generator's seed and offset and
                # advances it, so every replay draws anew.
                graph.register_generator_state(self._generator)
        with torch.cuda.graph(graph, stream=self._stream, capture_error_mode='thread_local'):
            self._static_out = self._run(state, self._static_inputs)
        graph.instantiate()
        self._optimizer_view = _optimizer_view(state.optimizer)
        self.graph = graph


def _classifier_metrics(losses, accuracies):
    return {'loss': losses.mean(), 'accuracy': accuracies.mean(), 'last_loss': losses[-1]}


def make_scan_train_step(microbatches=8, preprocess=None, generator=None, mesh=None,
                         batch_axis='data'):
    """``step(state, images [K*B, ...], labels [K*B]) -> {'loss': mean,
    'accuracy': mean, 'last_loss'}``: K = ``microbatches`` sequential SGD
    steps a call (``petastorm_tpu/models/train.py:108-149``), one CUDA graph
    replay on the card (:class:`ScanStep`). ``preprocess(images_microbatch)``
    runs inside the body (and the graph), e.g. the K1 normalize; with a
    ``generator`` it is called as ``preprocess(images_microbatch,
    generator)`` and draws from it (a random augment), and the graph
    registers the generator, so each replay draws anew. Metrics are 0-d
    tensors, not synchronised. On a mesh (the state's; ``mesh``, if given,
    must be it) the gradient all-reduce runs inside the captured graph: the
    eager first call has made the process groups' communicators."""
    if generator is not None and preprocess is None:
        raise ValueError('a generator is drawn from by the preprocess; none was given')

    def body(state, images, labels):
        _check_mesh(state, mesh, batch_axis)
        if generator is not None:
            images = preprocess(images, generator)
        elif preprocess is not None:
            images = preprocess(images)
        return _classifier_step(state, images, labels)

    return ScanStep(body, _classifier_metrics, microbatches, generator)


def _lm_scan_metrics(losses, aux=None):
    return {'losses': losses} if aux is None else {'losses': losses, 'aux_losses': aux}


def make_lm_scan_train_step(microbatches=8, mesh=None, batch_axis='data'):
    """``step(state, tokens [K*B, T + 1]) -> {'losses': [K]}``: the scan
    counterpart of :func:`make_lm_train_step`, the ``lax.scan`` of
    ``bench.py:216-244``; one CUDA graph replay on the card. A model with
    experts also returns ``'aux_losses'`` ``[K]``. On a mesh as
    :func:`make_scan_train_step`."""
    def body(state, tokens):
        _check_mesh(state, mesh, batch_axis)
        return _lm_step(state, tokens)

    return ScanStep(body, _lm_scan_metrics, microbatches)

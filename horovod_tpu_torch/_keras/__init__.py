"""Shared Keras implementation of the port (counterpart of
``horovod_tpu/_keras/__init__.py``; parity: horovod/_keras/__init__.py).

``create_distributed_optimizer`` uses the reference's dynamic-subclass
trick: a subclass of the user's optimizer class that allreduces the
gradients in ``apply`` (the one funnel of Keras 3's ``apply_gradients``
and ``model.fit``) before the original math, rebuilt ``from_config``.
``make_distributed_class`` exposes the subclass for ``load_model``,
which wraps a loaded optimizer in place and registers the
``Distributed*`` names as custom objects, so that a checkpoint saved
from a wrapped optimizer loads, whichever package wrapped it.

``backward_passes_per_step > 1`` aggregates locally (parity:
horovod/tensorflow/aggregation_helper.py): the gradients accumulate in
tf.Variables for N micro-steps, and every N-th step the (optionally
averaged) sum is allreduced and applied; the other steps skip the
base apply, so slots and ``iterations`` move only on those steps.
"""

from __future__ import annotations


def make_distributed_class(base_cls, compression=None, op=None,
                           gradient_predivide_factor=1.0,
                           backward_passes_per_step=1,
                           average_aggregated_gradients=True,
                           process_set=None):
    """Build the allreduce-wrapping subclass of ``base_cls`` (parity:
    the class the reference's create_distributed_optimizer generates,
    factored out so load_model can register it as a custom object)."""
    from ..tensorflow import Average, allreduce
    from ..tensorflow.compression import Compression
    from ..tensorflow.mpi_ops import predivide_scaling

    compression = compression or Compression.none
    op = op if op is not None else Average
    bpps = int(backward_passes_per_step)
    if bpps < 1:
        raise ValueError(
            f"backward_passes_per_step must be >= 1, got {bpps}"
        )

    class _DistributedOptimizer(base_cls):
        """Allreduce-averaging subclass (parity: _keras
        create_distributed_optimizer's generated class)."""

        _hvtpu_distributed = True
        _hvtpu_backward_passes_per_step = bpps

        def apply(self, grads, trainable_variables=None, **kwargs):
            grads = list(grads)
            if bpps == 1:
                grads = self._hvtpu_allreduce_grads(grads)
                return super().apply(grads, trainable_variables, **kwargs)
            return self._hvtpu_aggregate_apply(
                grads, trainable_variables, **kwargs
            )

        def _hvtpu_allreduce_grads(self, grads):
            eff_op, prescale, postscale = predivide_scaling(
                op, gradient_predivide_factor, process_set
            )
            out = []
            for g in grads:
                if g is None:
                    out.append(None)
                    continue
                out.append(allreduce(
                    g, op=eff_op, compression=compression,
                    prescale_factor=prescale, postscale_factor=postscale,
                    process_set=process_set,
                ))
            return out

        def _hvtpu_aggregate_apply(self, grads, trainable_variables,
                                   **kwargs):
            """Accumulate for bpps micro-steps; every bpps-th step
            allreduce the (optionally averaged) aggregate and run the
            REAL apply — other steps skip the base apply entirely, so
            stateful optimizers (Adam m/v, momentum) and
            ``iterations`` only advance on aggregate steps (parity:
            LocalGradientAggregationHelper skipping non-sync applies).
            """
            import tensorflow as tf

            if trainable_variables is not None and not self.built:
                self.build(trainable_variables)
            if not hasattr(self, "_hvtpu_acc"):
                self._hvtpu_counter = tf.Variable(
                    0, dtype=tf.int64, trainable=False,
                    name="hvtpu_agg_counter",
                )
                self._hvtpu_acc = [
                    None if g is None else tf.Variable(
                        tf.zeros_like(tf.convert_to_tensor(g)),
                        trainable=False, name=f"hvtpu_agg_{i}",
                    )
                    for i, g in enumerate(grads)
                ]
            self._hvtpu_counter.assign_add(1)
            for acc, g in zip(self._hvtpu_acc, grads):
                if acc is not None and g is not None:
                    acc.assign_add(tf.convert_to_tensor(g))
            is_sync = tf.equal(self._hvtpu_counter % bpps, 0)
            live_acc = [a for a in self._hvtpu_acc if a is not None]

            def do_sync():
                gs = [a.read_value() for a in live_acc]
                if average_aggregated_gradients:
                    gs = [g / float(bpps) for g in gs]
                gs = self._hvtpu_allreduce_grads(gs)
                full, it = [], iter(gs)
                for a in self._hvtpu_acc:
                    full.append(None if a is None else next(it))
                base_cls.apply(self, full, trainable_variables, **kwargs)
                for a in live_acc:
                    a.assign(tf.zeros_like(a))
                return tf.constant(True)

            def no_sync():
                return tf.constant(False)

            tf.cond(is_sync, do_sync, no_sync)
            return None

    _DistributedOptimizer.__name__ = "Distributed" + base_cls.__name__
    return _DistributedOptimizer


def create_distributed_optimizer(optimizer, name=None, compression=None,
                                 op=None, gradient_predivide_factor=1.0,
                                 backward_passes_per_step=1,
                                 average_aggregated_gradients=True,
                                 process_set=None):
    cls = make_distributed_class(
        optimizer.__class__, compression=compression, op=op,
        gradient_predivide_factor=gradient_predivide_factor,
        backward_passes_per_step=backward_passes_per_step,
        average_aggregated_gradients=average_aggregated_gradients,
        process_set=process_set,
    )
    config = optimizer.get_config()
    if name is not None:
        config["name"] = name
    return cls.from_config(config)


def load_model_impl(keras_module, filepath, custom_optimizers=None,
                    custom_objects=None, compression=None):
    """Parity: horovod/_keras/__init__.py ``_load_model`` — load a
    saved keras model and wrap its optimizer in the distributed
    subclass, preserving the saved optimizer state (iterations, slot
    variables).

    Keras 3 resolves BUILT-IN optimizer classes by module path and
    never consults custom_objects for them, so a plain-optimizer
    checkpoint is wrapped AFTER load: swap the live optimizer's class
    to the generated subclass in place (same instance, all restored
    variables untouched), falling back to rebuild-from-config +
    variable copy for optimizers whose layout rejects the swap.  A
    checkpoint saved from an ALREADY-wrapped optimizer records
    ``Distributed<Base>`` under this module — those names ARE looked
    up in custom_objects, so they're pre-registered here (the
    reference's horovod_objects role); ``custom_optimizers`` extends
    that registry with user optimizer classes."""
    horovod_objects = {}
    base = keras_module.optimizers.Optimizer
    opt_classes = [
        cls for name in dir(keras_module.optimizers)
        if isinstance(cls := getattr(keras_module.optimizers, name),
                      type) and issubclass(cls, base) and cls is not base
    ]
    # user classes LAST so a name collision resolves to the user's
    # optimizer (reference horovod_objects.update order)
    opt_classes.extend(custom_optimizers or [])
    for cls in opt_classes:
        horovod_objects["Distributed" + cls.__name__] = \
            make_distributed_class(cls, compression=compression)
    horovod_objects.update(custom_objects or {})
    model = keras_module.models.load_model(
        filepath, custom_objects=horovod_objects)
    opt = getattr(model, "optimizer", None)
    if opt is None or getattr(opt, "_hvtpu_distributed", False):
        return model
    cls = make_distributed_class(opt.__class__,
                                 compression=compression)
    try:
        opt.__class__ = cls
    except TypeError:
        new_opt = cls.from_config(opt.get_config())
        if getattr(opt, "built", False):
            new_opt.build(model.trainable_variables)
            if len(new_opt.variables) != len(opt.variables):
                raise ValueError(
                    f"optimizer rebuild produced "
                    f"{len(new_opt.variables)} variables vs "
                    f"{len(opt.variables)} loaded — refusing a "
                    "partial state copy")
            for dst, src in zip(new_opt.variables, opt.variables):
                dst.assign(src)
        model.optimizer = new_opt
    return model

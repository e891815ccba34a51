"""Evaluation metrics (counterpart of ``incubator_mxnet_tpu/metric.py``,
kept as the port's own copy; reference python/mxnet/metric.py).

The same registry and ``EvalMetric`` API.  Every metric accumulates on
the host in numpy after a device sync (``NDArray.asnumpy``), as the
reference's metrics are the sync point of its asynchronous engine.
"""
from __future__ import annotations

import math

import numpy

from .base import registry

numeric_types = (float, int, numpy.generic)

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register"]

_REG = registry("metric")


def register(klass):
    _REG.register(klass.__name__.lower(), klass)
    return klass


def _as_numpy(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else numpy.asarray(x)


def check_label_shapes(labels, preds, shape=False):
    if shape:
        label_shape = tuple(labels.shape)
        pred_shape = tuple(preds.shape)
    else:
        label_shape, pred_shape = len(labels), len(preds)
    if label_shape != pred_shape:
        raise ValueError(
            f"Shape of labels {label_shape} does not match shape of"
            f" predictions {pred_shape}")


class EvalMetric:
    """Base metric (reference metric.py:EvalMetric)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"

    def get_config(self):
        config = self._kwargs.copy()
        config.update({
            "metric": self.__class__.__name__,
            "name": self.name,
            "output_names": self.output_names,
            "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


def create(metric, *args, **kwargs):
    """Create from name / callable / list (reference metric.py:create)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    return _REG.get(metric)(*args, **kwargs)


@register
class CompositeEvalMetric(EvalMetric):
    """Manage multiple metrics as one (reference metric.py:CompositeEvalMetric)."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        if metrics is None:
            metrics = []
        self.metrics = [create(i) for i in metrics]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            raise ValueError(f"Metric index {index} is out of range 0 and"
                             f" {len(self.metrics)}") from None

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, numeric_types):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)

    def get_config(self):
        config = super().get_config()
        config.update({"metrics": [i.get_config() for i in self.metrics]})
        return config


@register
class Accuracy(EvalMetric):
    """Classification accuracy (reference metric.py:Accuracy)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        if not isinstance(labels, list):
            labels = [labels]
        if not isinstance(preds, list):
            preds = [preds]
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_label = _as_numpy(pred_label)
            label = _as_numpy(label)
            if pred_label.shape != label.shape:
                pred_label = pred_label.argmax(self.axis)
            pred_label = pred_label.astype("int32").ravel()
            label = label.astype("int32").ravel()
            check_label_shapes(label, pred_label)
            self.sum_metric += (pred_label == label).sum()
            self.num_inst += len(pred_label)


@register
class TopKAccuracy(EvalMetric):
    """Top-k accuracy (reference metric.py:TopKAccuracy)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        if not (self.top_k > 1):
            raise ValueError("Please use Accuracy if top_k is no more than 1")
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        if not isinstance(labels, list):
            labels = [labels]
        if not isinstance(preds, list):
            preds = [preds]
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            if not (len(pred_label.shape) == 2):
                raise ValueError("Predictions should be a 2 dims matrix")
            pred_label = numpy.argsort(_as_numpy(pred_label).astype("float32"),
                                    axis=1)
            label = _as_numpy(label).astype("int32")
            check_label_shapes(label, pred_label)
            num_samples = pred_label.shape[0]
            num_dims = len(pred_label.shape)
            if num_dims == 1:
                self.sum_metric += (pred_label.ravel() == label.ravel()).sum()
            elif num_dims == 2:
                num_classes = pred_label.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (
                        pred_label[:, num_classes - 1 - j].ravel() ==
                        label.ravel()).sum()
            self.num_inst += num_samples


@register
class F1(EvalMetric):
    """Binary F1 (reference metric.py:F1)."""

    def __init__(self, name="f1", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        if not isinstance(labels, list):
            labels = [labels]
        if not isinstance(preds, list):
            preds = [preds]
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype("int32")
            pred_label = numpy.argmax(pred, axis=1)
            check_label_shapes(label, pred)
            if len(numpy.unique(label)) > 2:
                raise ValueError("F1 currently only supports binary"
                                 " classification.")
            true_positives, false_positives, false_negatives = 0., 0., 0.
            for y_pred, y_true in zip(pred_label, label):
                if y_pred == 1 and y_true == 1:
                    true_positives += 1.
                elif y_pred == 1 and y_true == 0:
                    false_positives += 1.
                elif y_pred == 0 and y_true == 1:
                    false_negatives += 1.
            if true_positives + false_positives > 0:
                precision = true_positives / (true_positives + false_positives)
            else:
                precision = 0.
            if true_positives + false_negatives > 0:
                recall = true_positives / (true_positives + false_negatives)
            else:
                recall = 0.
            if precision + recall > 0:
                f1_score = 2 * precision * recall / (precision + recall)
            else:
                f1_score = 0.
            self.sum_metric += f1_score
            self.num_inst += 1


@register
class Perplexity(EvalMetric):
    """exp(mean NLL) (reference metric.py:Perplexity)."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        if not (len(labels) == len(preds)):
            raise ValueError('expected len(labels) == len(preds)')
        loss = 0.
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if self.axis not in (-1, pred.ndim - 1):
                pred = numpy.moveaxis(pred, self.axis, -1)
            if not (label.size == pred.size / pred.shape[-1]):
                raise ValueError("shape mismatch")
            label = label.reshape((label.size,)).astype("int32")
            probs = pred.reshape(-1, pred.shape[-1])[
                numpy.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                num -= int(ignore.sum())
                probs = probs * (1 - ignore) + ignore
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += label.size
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    """Mean absolute error (reference metric.py:MAE)."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += numpy.abs(label - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    """Mean squared error (reference metric.py:MSE)."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


@register
class RMSE(EvalMetric):
    """Root mean squared error (reference metric.py:RMSE)."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += numpy.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


@register
class CrossEntropy(EvalMetric):
    """CE over predicted probabilities (reference metric.py:CrossEntropy)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            label = label.ravel()
            if not (label.shape[0] == pred.shape[0]):
                raise ValueError('expected label.shape[0] == pred.shape[0]')
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(EvalMetric):
    """NLL (reference metric.py:NegativeLogLikelihood)."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            label = label.ravel()
            num_examples = pred.shape[0]
            if not (label.shape[0] == num_examples):
                raise ValueError(f"{label.shape[0]} labels for "
                                 f"{num_examples} predictions")
            prob = pred[numpy.arange(num_examples, dtype=numpy.int64),
                        numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += num_examples


@register
class PearsonCorrelation(EvalMetric):
    """Pearson correlation (reference metric.py:PearsonCorrelation)."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, 1)
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            self.sum_metric += numpy.corrcoef(pred.ravel(), label.ravel())[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Mean of a loss output (reference metric.py:Loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if not isinstance(preds, list):
            preds = [preds]
        for pred in preds:
            pred = _as_numpy(pred)
            self.sum_metric += pred.sum()
            self.num_inst += pred.size


@register
class Torch(Loss):
    """Legacy alias (reference metric.py:Torch)."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    """Legacy alias (reference metric.py:Caffe)."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """Metric from a feval function (reference metric.py:CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = f"custom({name})"
        super().__init__(name, output_names, label_names,
                         feval=feval, allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval as a metric (reference metric.py:np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


# short aliases matching the reference registry (metric.py register names):
# mx.metric.create('acc') / 'ce' / 'nll_loss' / 'top_k_accuracy' all resolve
for _alias, _cls in (("acc", Accuracy), ("ce", CrossEntropy),
                     ("nll_loss", NegativeLogLikelihood),
                     ("top_k_accuracy", TopKAccuracy),
                     ("top_k_acc", TopKAccuracy),
                     ("pcc", PearsonCorrelation),
                     ("cross-entropy", CrossEntropy)):
    _REG.register(_alias, _cls)

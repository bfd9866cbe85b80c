"""The vision model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo/
vision``, ref: python/mxnet/gluon/model_zoo/vision/__init__.py): the
ResNets, v1 and v2 at 18, 34, 50, 101 and 152 layers. AlexNet, VGG,
SqueezeNet, MobileNet, DenseNet and Inception are ROADMAP queue 1; their
names raise."""
from .resnet import (get_resnet, resnet18_v1, resnet34_v1, resnet50_v1,
                     resnet101_v1, resnet152_v1, resnet18_v2, resnet34_v2,
                     resnet50_v2, resnet101_v2, resnet152_v2, ResNetV1,
                     ResNetV2)

_models = {
    'resnet18_v1': resnet18_v1, 'resnet34_v1': resnet34_v1,
    'resnet50_v1': resnet50_v1, 'resnet101_v1': resnet101_v1,
    'resnet152_v1': resnet152_v1, 'resnet18_v2': resnet18_v2,
    'resnet34_v2': resnet34_v2, 'resnet50_v2': resnet50_v2,
    'resnet101_v2': resnet101_v2, 'resnet152_v2': resnet152_v2,
}

# the JAX package's other names, not ported yet (ROADMAP queue 1)
_not_ported = (
    ['alexnet', 'squeezenet1.0', 'squeezenet1.1', 'inceptionv3'] +
    [f'vgg{n}{bn}' for n in (11, 13, 16, 19) for bn in ('', '_bn')] +
    [f'densenet{n}' for n in (121, 161, 169, 201)] +
    [f'mobilenet{m}' for m in ('1.0', '0.75', '0.5', '0.25')] +
    [f'mobilenetv2_{m}' for m in ('1.0', '0.75', '0.5', '0.25')])


def get_model(name, **kwargs):
    """A zoo model by name (ref: model_zoo/vision/__init__.py get_model);
    an unknown name raises ValueError."""
    name = name.lower()
    if name in _not_ported:
        from ....base import MXNetError
        raise MXNetError(f"model {name!r} is not ported yet (ROADMAP queue "
                         f"1: the rest of the vision zoo)")
    if name not in _models:
        raise ValueError(f"Model {name} is not supported. Available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)

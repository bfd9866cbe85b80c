"""The vision model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo/
vision``, ref: python/mxnet/gluon/model_zoo/vision/__init__.py): ResNet
v1 and v2, VGG, AlexNet, DenseNet, SqueezeNet, Inception v3 and MobileNet
v1 and v2, each by the JAX package's name through ``get_model``;
``pretrained=True`` loads through ``model_store`` from local files."""
from .resnet import (get_resnet, resnet18_v1, resnet34_v1, resnet50_v1,
                     resnet101_v1, resnet152_v1, resnet18_v2, resnet34_v2,
                     resnet50_v2, resnet101_v2, resnet152_v2, ResNetV1,
                     ResNetV2)
from .alexnet import alexnet, AlexNet
from .vgg import (vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn, vgg16_bn,
                  vgg19_bn, VGG, get_vgg)
from .squeezenet import squeezenet1_0, squeezenet1_1, SqueezeNet
from .densenet import (densenet121, densenet161, densenet169, densenet201,
                       DenseNet)
from .mobilenet import (mobilenet1_0, mobilenet0_75, mobilenet0_5,
                        mobilenet0_25, mobilenet_v2_1_0, mobilenet_v2_0_75,
                        mobilenet_v2_0_5, mobilenet_v2_0_25, MobileNet,
                        MobileNetV2)
from .inception import inception_v3, Inception3

_models = {
    'resnet18_v1': resnet18_v1, 'resnet34_v1': resnet34_v1,
    'resnet50_v1': resnet50_v1, 'resnet101_v1': resnet101_v1,
    'resnet152_v1': resnet152_v1, 'resnet18_v2': resnet18_v2,
    'resnet34_v2': resnet34_v2, 'resnet50_v2': resnet50_v2,
    'resnet101_v2': resnet101_v2, 'resnet152_v2': resnet152_v2,
    'vgg11': vgg11, 'vgg13': vgg13, 'vgg16': vgg16, 'vgg19': vgg19,
    'vgg11_bn': vgg11_bn, 'vgg13_bn': vgg13_bn, 'vgg16_bn': vgg16_bn,
    'vgg19_bn': vgg19_bn, 'alexnet': alexnet,
    'densenet121': densenet121, 'densenet161': densenet161,
    'densenet169': densenet169, 'densenet201': densenet201,
    'squeezenet1.0': squeezenet1_0, 'squeezenet1.1': squeezenet1_1,
    'inceptionv3': inception_v3,
    'mobilenet1.0': mobilenet1_0, 'mobilenet0.75': mobilenet0_75,
    'mobilenet0.5': mobilenet0_5, 'mobilenet0.25': mobilenet0_25,
    'mobilenetv2_1.0': mobilenet_v2_1_0, 'mobilenetv2_0.75': mobilenet_v2_0_75,
    'mobilenetv2_0.5': mobilenet_v2_0_5, 'mobilenetv2_0.25': mobilenet_v2_0_25,
}


def get_model(name, **kwargs):
    """A zoo model by name (ref: model_zoo/vision/__init__.py get_model);
    an unknown name raises ValueError."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"Model {name} is not supported. Available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)

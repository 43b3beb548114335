"""Model zoo: the transformer LM the decode path serves, and the image
classifiers the training path fits (ResNet, MLP, LeNet, AlexNet, VGG,
Inception-BN, Inception-v3)."""
from . import lenet, mlp, resnet, transformer
from . import alexnet, vgg, inception_bn, inception_v3

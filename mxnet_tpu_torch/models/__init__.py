"""Model zoo: the transformer LM the decode path serves, and the image
classifiers the training path fits (ResNet, MLP, LeNet)."""
from . import lenet, mlp, resnet, transformer

"""Module family: Module, BucketingModule and the one-device executor
group."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup

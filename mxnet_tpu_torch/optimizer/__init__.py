"""Optimizers (the port of ``mxnet_tpu/optimizer``)."""
from .optimizer import (SGD, Adam, AdaDelta, AdaGrad, Adamax, DCASGD, FTML,
                        Ftrl, LBSGD, NAG, Nadam, Optimizer, RMSProp, SGLD,
                        Signum, Test, Updater, create, get_updater, register)

__all__ = ["Optimizer", "SGD", "Adam", "AdaDelta", "AdaGrad", "Adamax",
           "DCASGD", "FTML", "Ftrl", "LBSGD", "NAG", "Nadam", "RMSProp",
           "SGLD", "Signum", "Test", "Updater", "create", "get_updater",
           "register"]

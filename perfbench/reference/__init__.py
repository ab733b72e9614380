"""The benchmark's plain reference: plain PyTorch, no kernel, no package of
the program imported. The model modules are a frozen copy of the port's
plain paths (``multitask.py`` and the modules it builds); ``step.py``
holds the train step, the optimizer and the eval forward."""

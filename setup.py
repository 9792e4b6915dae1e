"""Package setup; also builds the native host-kernel library.

The native library normally builds lazily at import (orienmask_tpu/native); this
setup lets you prebuild it explicitly:  ``python setup.py build_native``.
"""

from setuptools import Command, find_packages, setup


class BuildNative(Command):
    description = "compile orienmask_tpu/native/src into build/libomtpu.so"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        from orienmask_tpu.native import _build

        _build()
        print("built orienmask_tpu/native/build/libomtpu.so")


setup(
    name="orienmask_tpu",
    version="0.1.0",
    description="TPU-native OrienMask real-time instance segmentation framework",
    packages=find_packages(include=["orienmask_tpu", "orienmask_tpu.*",
                                    "orienmask_tpu_torch", "orienmask_tpu_torch.*"]),
    python_requires=">=3.10",
    cmdclass={"build_native": BuildNative},
)

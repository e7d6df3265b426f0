from setuptools import setup, find_packages

setup(
    name="rustracer-tpu",
    version="0.1.0",
    description="Differentiable physically-based wavefront renderer "
                "(JAX/XLA + native C++ BVH builder)",
    packages=find_packages(include=["rustracer_tpu", "rustracer_tpu.*"]),
    python_requires=">=3.10",
    entry_points={"console_scripts": ["rustracer-tpu=rustracer_tpu.utils.cli:main"]},
)

"""The envpool_lite native MuJoCo engine (`envpool_lite.cc`), built with g++
at first use by `build.build()`."""

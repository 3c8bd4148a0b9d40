"""The benchmark of videoprocessingframework_torch on one NVIDIA H100:

    python3 vpfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
"""

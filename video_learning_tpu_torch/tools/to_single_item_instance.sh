#!/usr/bin/env bash
# Deduplicate a `path label...` list file down to the first line of each
# item (the port's copy of video_learning_tpu/tools/to_single_item_instance.sh).
# Usage: to_single_item_instance.sh in.txt > out.txt
awk '!seen[$1]++' "$1"

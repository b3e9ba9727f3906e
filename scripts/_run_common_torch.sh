#!/usr/bin/env bash
# Shared launcher core of the PyTorch port (busca_tpu_torch.eval.run): the
# same flag surface as scripts/_run_common.sh and the reference's
# scripts/run_*.sh (--dataset, --testset, --use-busca, --busca-config,
# --busca-ckpt, --output-base-folder, --online-visualization; any other
# argument goes to the CLI as is), the same experiment-dir layout
# exp/<Tracker>/<DATASET>/<testset>/<ts>_<name>_{BUSCA,BASE}/track_results,
# the same per-dataset checkpoint and config choice, and the same MOT17-test
# FRCNN->DPM/SDP result replication.
#
# The port runs on the card unless the extra arguments say --device cpu.
# Checkpoints load as they are: an official YOLOX .pth.tar, a reference
# BUSCA .pth or a busca_tpu .npz (no conversion step).
#
# Callers set: TRACKER_NAME, TRACKER_FLAG (value for --tracker), and
# optionally DETECTOR_FLAGS (e.g. "--detector yolox-x").  The per-dataset
# detector checkpoints below are ByteTrack's YOLOX-X releases, passed only
# to a yolox detector; CenterTrack and TransCenter take theirs as an extra
# --detector-ckpt argument.
#
# Data/checkpoints come from env (external downloads, not shipped):
#   MOT_DATA_DIR   root holding MOT17/ and MOT20/ (default ./datasets)
#   CKPT_DIR       detector checkpoints (default ./pretrained)

set -euo pipefail

REPO_FOLDER=$(dirname "${BASH_SOURCE[0]}")
REPO_FOLDER=$(realpath "${REPO_FOLDER}/..")

EXP_DATE="$(date +"%Y-%m-%d_%H-%M-%S")"
EXP_NAME="${EXP_DATE}_${TRACKER_NAME}"

DATASET="MOT17"
TEST_SET="val"
USE_BUSCA=false
BUSCA_CONFIG=""
BUSCA_CHECKPOINT="${BUSCA_CHECKPOINT:-${REPO_FOLDER}/models/BUSCA/motsynth/model_busca.pth}"
OUTPUT_BASE_FOLDER="${REPO_FOLDER}/exp"
ONLINE_VISUALIZATION=false
MOT_DATA_DIR="${MOT_DATA_DIR:-${REPO_FOLDER}/datasets}"
CKPT_DIR="${CKPT_DIR:-${REPO_FOLDER}/pretrained}"
EXTRA_ARGS=()

while [[ $# -gt 0 ]]; do
    case $1 in
        --dataset) DATASET="$2"; shift 2 ;;
        --testset) TEST_SET="$2"; shift 2 ;;
        --use-busca) USE_BUSCA=true; shift ;;
        --online-visualization) ONLINE_VISUALIZATION=true; shift ;;
        --busca-config) BUSCA_CONFIG="$2"; shift 2 ;;
        --busca-ckpt) BUSCA_CHECKPOINT="$2"; shift 2 ;;
        --output-base-folder) OUTPUT_BASE_FOLDER="$2"; shift 2 ;;
        *) EXTRA_ARGS+=("$1"); shift ;;
    esac
done

# per-dataset BUSCA config default (resolved AFTER parsing so --dataset is
# honored, like the reference scripts' per-dataset selection)
if [ -z "${BUSCA_CONFIG}" ]; then
    tracker_low=$(echo "${TRACKER_NAME}" | tr '[:upper:]' '[:lower:]')
    dataset_low=$(echo "${DATASET}" | tr '[:upper:]' '[:lower:]')
    BUSCA_CONFIG="${REPO_FOLDER}/config/${TRACKER_NAME}/${DATASET}/config_${tracker_low}_${dataset_low}.yml"
fi

if [ "$USE_BUSCA" = true ]; then
    busca_args=(--use-busca --busca-config "${BUSCA_CONFIG}" --busca-ckpt "${BUSCA_CHECKPOINT}")
    exp_name="${EXP_NAME}_BUSCA"
else
    busca_args=()
    exp_name="${EXP_NAME}_BASE"
fi

viz_args=()
if [ "$ONLINE_VISUALIZATION" = true ]; then
    viz_args=(--online-visualization)
fi

# dataset/testset -> sequence dirs + detector checkpoint (reference ckpt
# selection logic; the .pth.tar files load as they are)
case "${DATASET}/${TEST_SET}" in
    MOT17/val)  split_dir="${MOT_DATA_DIR}/MOT17/train"; det_ckpt="${CKPT_DIR}/bytetrack_ablation.pth.tar" ;;
    MOT17/test) split_dir="${MOT_DATA_DIR}/MOT17/test";  det_ckpt="${CKPT_DIR}/bytetrack_x_mot17.pth.tar" ;;
    MOT20/val)  split_dir="${MOT_DATA_DIR}/MOT20/train"; det_ckpt="${CKPT_DIR}/bytetrack_x_mot20.tar" ;;
    MOT20/test) split_dir="${MOT_DATA_DIR}/MOT20/test";  det_ckpt="${CKPT_DIR}/bytetrack_x_mot20.tar" ;;
    *) echo "ERROR: dataset must be MOT17|MOT20, testset val|test"; exit 1 ;;
esac

output_dir="${OUTPUT_BASE_FOLDER}/${TRACKER_NAME}/${DATASET}/${TEST_SET}/${exp_name}"
results_dir="${output_dir}/track_results"
log_file="${output_dir}/out.txt"
mkdir -p "${results_dir}"
touch "${log_file}"

seq_dirs=()
if [ -d "${split_dir}" ]; then
    for d in "${split_dir}"/*/; do
        case "${DATASET}" in
            # MOT17 ships each sequence 3x (DPM/FRCNN/SDP public dets with
            # identical frames/gt); only the FRCNN copies are evaluated
            MOT17) [[ "$d" == *FRCNN* ]] && seq_dirs+=("$d") ;;
            *) seq_dirs+=("$d") ;;
        esac
    done
    # non-MOTChallenge layouts (no FRCNN suffix): take every sequence dir
    if [ ${#seq_dirs[@]} -eq 0 ]; then
        for d in "${split_dir}"/*/; do
            [ -d "$d" ] && seq_dirs+=("$d")
        done
    fi
fi
if [ ${#seq_dirs[@]} -eq 0 ]; then
    echo "ERROR: no sequences under ${split_dir} (set MOT_DATA_DIR)"; exit 1
fi

det_args=()
if [ -n "${DETECTOR_FLAGS:-}" ]; then
    det_args=(${DETECTOR_FLAGS})
    if [[ "${DETECTOR_FLAGS}" == *yolox* ]] && [ -f "${det_ckpt}" ]; then
        det_args+=(--detector-ckpt "${det_ckpt}")
    fi
fi

echo "${exp_name}" | tee -a "${log_file}"
echo "Running tracker ${TRACKER_NAME} on ${DATASET} (${TEST_SET})" | tee -a "${log_file}"
[ "$USE_BUSCA" = true ] && echo "BUSCA ENABLED (${BUSCA_CONFIG})" | tee -a "${log_file}"

PYTHONPATH="${REPO_FOLDER}:${PYTHONPATH:-}" python3 -m busca_tpu_torch.eval.run \
    --tracker "${TRACKER_FLAG}" \
    --mot-dir "${seq_dirs[@]}" \
    --output-dir "${results_dir}" \
    ${det_args[@]+"${det_args[@]}"} ${busca_args[@]+"${busca_args[@]}"} \
    ${viz_args[@]+"${viz_args[@]}"} \
    ${EXTRA_ARGS[@]+"${EXTRA_ARGS[@]}"} 2>&1 | tee -a "${log_file}"

# Replicate MOT17 test results: only -FRCNN videos are evaluated; copy to
# -DPM/-SDP for the server format (reference run_bytetrack.sh tail)
if [ "${DATASET}" = "MOT17" ] && [ "${TEST_SET}" = "test" ]; then
    for res_file in "${results_dir}"/MOT17-*-FRCNN.txt; do
        [ -e "$res_file" ] || continue
        base_name="${res_file%-FRCNN.txt}"
        cp "$res_file" "${base_name}-DPM.txt"
        cp "$res_file" "${base_name}-SDP.txt"
    done
fi

echo "Experiment ${exp_name} done! Results: ${results_dir}" | tee -a "${log_file}"

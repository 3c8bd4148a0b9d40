"""Runnable samples of the port, one for each sample of the JAX package
(``samples/``), under the same name; ``sample_jax_resnet.py`` became
``sample_resnet``. Each runs as

    python -m videoprocessingframework_torch.samples.<name> [args]

and takes ``--device`` (CUDA by default, which raises without a GPU;
``--device cpu`` runs on the CPU). Each has ``main(argv=None) -> int``;
those with a device stage keep it in a plain ``run(...)`` function over
host frames or batches, a model and a device.

=================================  ====================================
JAX sample (samples/)              port (this package)
=================================  ====================================
sample_decode.py                   sample_decode
sample_decode_sw.py                sample_decode_sw
sample_demux_decode.py             sample_demux_decode
sample_decode_rtsp.py              sample_decode_rtsp
sample_encode.py                   sample_encode
sample_encode_multi_thread.py      sample_encode_multi_thread
sample_transcode.py                sample_transcode
sample_dlpack.py                   sample_dlpack
sample_torch.py                    sample_torch
sample_remap.py                    sample_remap
sample_display.py                  sample_display
sample_jax_resnet.py               sample_resnet
sample_segmentation.py             sample_segmentation
sample_serving.py                  sample_serving
sample_batch_inference.py          sample_batch_inference
sample_decode_multi_thread.py      sample_decode_multi_thread
sample_aot_compile.py              sample_aot_compile
sample_device_transcode.py         sample_device_transcode
sample_dataloader.py               sample_dataloader
sample_train_video.py              sample_train_video
sample_scenecut.py                 sample_scenecut
sample_stabilize.py                sample_stabilize
sample_flow_interp.py              sample_flow_interp
sample_measure_video_quality.py    sample_measure_video_quality
sample_mjpeg_transcode.py          sample_mjpeg_transcode
utils.py                           _utils
=================================  ====================================
"""
